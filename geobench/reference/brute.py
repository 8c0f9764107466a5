"""Plain answers to the benchmark's requests, by brute force.

``Rows`` holds the seeded points on one device, sorted by the key that
narrows a request (the time where the rows have one, else x), and answers:

- ``bbox_ids``: rows with x0 <= x <= x1, y0 <= y <= y1 and, with a window,
  lo <= t < hi (DURING is half open), as sorted row ids.

Coordinates are compared in ``dtype`` (float64 for the reference; the
control passes float32 to put a lower precision in the program's place).
Times are whole milliseconds in int64.
"""

from __future__ import annotations

import torch


class Rows:
    def __init__(self, x, y, t=None, device="cpu", dtype=torch.float64):
        dev = torch.device(device)
        key = torch.as_tensor(t if t is not None else x).to(dev)
        key, order = torch.sort(key, stable=True)
        self.key = key
        self.timed = t is not None
        self.ids = order
        self.dtype = dtype
        self.x = torch.as_tensor(x).to(dev)[order].to(dtype)
        self.y = torch.as_tensor(y).to(dev)[order].to(dtype)
        self.device = dev

    def scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float64).to(self.dtype).to(self.device)

    def span(self, window=None, x_lo=None, x_hi=None) -> tuple[int, int]:
        """The sorted rows a request can touch: its window on timed rows,
        else its x range (widened by a degree, so a lower precision's
        rounding cannot cross the cut)."""
        if self.timed:
            if window is None:
                return 0, len(self.key)
            lo, hi = (torch.tensor([v], dtype=self.key.dtype, device=self.device) for v in window)
            return int(torch.searchsorted(self.key, lo)), int(torch.searchsorted(self.key, hi))
        a = torch.tensor([x_lo - 1.0], dtype=self.key.dtype, device=self.device)
        b = torch.tensor([x_hi + 1.0], dtype=self.key.dtype, device=self.device)
        return int(torch.searchsorted(self.key, a)), int(torch.searchsorted(self.key, b, right=True))

    def bbox_ids(self, box, window=None) -> torch.Tensor:
        x0, y0, x1, y1 = (self.scalar(v) for v in box)
        a, b = self.span(window, box[0], box[2])
        x, y = self.x[a:b], self.y[a:b]
        m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        return torch.sort(self.ids[a:b][m]).values
