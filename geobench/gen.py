"""Seeded data and request streams of the benchmark.

Everything a run sends the store is made here from ``--seed`` and the
cell's two data files: the configuration (rows, span, clusters, and how
each attribute's values are drawn) and the traffic mix (client count,
request shape and its parameters). The point generator is a copy of
``chip_smoke.gdelt_points``; the vocabularies of the string attributes
copy ``chip_smoke.cameo_codes`` and ``actor_names``. Nothing here imports
the program.

A request stream deals its shapes from a deck: every run, whatever its
seed, sends the same mix of box sizes, windows and projections, each deck
shuffled anew, so a seed changes where requests land and in which order,
not how much work they ask for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DAY_MS = 86_400_000
HOUR_MS = 3_600_000

# seed-sequence tags, so the data and every client's streams draw apart
DATA_TAG = 0
MEASURED_TAG = 1
WARMUP_TAG = 2
SAMPLE_TAG = 3
ATTR_TAG = 4


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for ``seed`` and ``tags`` (any whole numbers >= 0)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, tags)]))


def t0_ms(config: dict) -> int:
    return int(np.datetime64(config["t0"], "ms").astype(np.int64))


def span_ms(config: dict) -> int:
    return int(config["span_days"]) * DAY_MS


# -- data ----------------------------------------------------------------


def gdelt_points(n, rng, n_clusters=64, sigma=(3.0, 2.0)):
    """World-wide events clustered around population centres: a uniform
    background and gaussian clusters, half each. Returns (x, y, centres)
    with centres ([n_clusters], [n_clusters]) as drawn first."""
    n_clustered = n // 2
    n_uniform = n - n_clustered
    cx = rng.uniform(-160, 160, n_clusters)
    cy = rng.uniform(-55, 65, n_clusters)
    which = rng.integers(0, n_clusters, n_clustered)
    x = np.concatenate([
        rng.uniform(-180, 180, n_uniform),
        np.clip(cx[which] + rng.normal(0, sigma[0], n_clustered), -180, 180),
    ])
    y = np.concatenate([
        rng.uniform(-90, 90, n_uniform),
        np.clip(cy[which] + rng.normal(0, sigma[1], n_clustered), -90, 90),
    ])
    return x, y, (cx, cy)


LETTERS = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
# the stems of compound actor names: countries, organisations and roles
# (GDELT's Actor1Name values are upper-case CAMEO actor names)
ACTOR_STEMS = (
    "UNITED STATES", "UNITED STATES", "UNITED STATES", "UNITED KINGDOM", "UNITED NATIONS",
    "UNITED ARAB EMIRATES", "PRESIDENT", "PRESIDENTIAL GUARD", "GOVERNMENT", "POLICE",
    "MILITARY", "SECURITY FORCES", "PRIME MINISTER", "EUROPEAN UNION", "CHINA", "RUSSIA",
    "IRAN", "ISRAEL", "INDIA", "PAKISTAN", "AFGHANISTAN", "NIGERIA", "SOUTH AFRICA",
)


def _word(rng, lo: int, hi: int) -> str:
    return "".join(rng.choice(LETTERS, int(rng.integers(lo, hi + 1))))


def cameo_codes(rng, size: int) -> list:
    """CAMEO-shaped event codes of 2-4 digits: the 20 root codes, their
    200 three-digit children and four-digit children of 16 of those
    (``size`` = 300 takes them all)."""
    roots = [f"{i:02d}" for i in range(1, 21)]
    three = [f"{r}{d}" for r in roots for d in range(10)]
    four = [f"{c}{d}" for c in rng.choice(three, 16, replace=False) for d in range(1, 6)]
    return (roots + three + four)[:size]


def actor_names(rng, size: int, lo_len=3, hi_len=40) -> list:
    """Distinct upper-case actor names of lo_len..hi_len characters:
    three in five a stem and a word, the rest one word."""
    out: dict = {}
    while len(out) < size:
        word = _word(rng, 3, 12)
        if rng.random() < 0.6:
            word = f"{ACTOR_STEMS[int(rng.integers(len(ACTOR_STEMS)))]} {word}"
        word = word[:hi_len]
        if len(word) >= lo_len:
            out.setdefault(word, None)
    return list(out)


def letter_codes(rng, size: int, length: int) -> list:
    """Distinct upper-case codes of ``length`` letters (ISO / FIPS
    country codes)."""
    out: dict = {}
    while len(out) < size:
        out.setdefault(_word(rng, length, length), None)
    return list(out)


def place_names(rng, size: int) -> list:
    """Distinct GDELT ``ActionGeo_FullName`` shapes: "City, Region,
    Country", "Region, Country" or "Country", 4-12 letters a part."""
    out: dict = {}
    while len(out) < size:
        parts = [_word(rng, 4, 12).title() for _ in range(int(rng.choice([1, 2, 3],
                                                                          p=[0.1, 0.3, 0.6])))]
        out.setdefault(", ".join(parts), None)
    return list(out)


VOCABULARIES = {
    "cameo_codes": lambda rng, v: cameo_codes(rng, int(v["size"])),
    "actor_names": lambda rng, v: actor_names(rng, int(v["size"])),
    "letter_codes": lambda rng, v: letter_codes(rng, int(v["size"]), int(v["length"])),
    "place_names": lambda rng, v: place_names(rng, int(v["size"])),
}


def zipf_ranks(rng, n_values: int, n: int, s: float, q: float) -> np.ndarray:
    """n draws of value ranks 0..n_values-1, Zipf-Mandelbrot skewed:
    P(rank k) ~ (k + 1 + q)^-s (``chip_smoke.zipf_ranks``)."""
    p = (np.arange(1, n_values + 1) + q) ** -s
    cdf = np.cumsum(p / p.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"), n_values - 1)


def decimal_text(values: np.ndarray, digits: int) -> np.ndarray:
    """Whole numbers below 10**digits as fixed-width decimal strings."""
    v = np.asarray(values, dtype=np.int64)
    pow10 = 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)
    codes = (v[:, None] // pow10 % 10 + ord("0")).astype(np.uint32)
    return np.ascontiguousarray(codes).view(f"<U{digits}").reshape(-1)


def attribute_column(spec: dict, n: int, rng, row_ids: np.ndarray) -> np.ndarray:
    """One attribute's ``n`` values as the configuration draws them:

    - ``row_text``: the row's id plus ``base`` as ``digits`` decimal
      characters (GDELT's GLOBALEVENTID);
    - ``vocabulary``: values of a seeded vocabulary (``VOCABULARIES``) by
      Zipf-Mandelbrot rank, ``empty_share`` of them the empty string;
    - ``geometric``: ``low`` plus a geometric count with success ``p``,
      capped at ``high``, int32;
    - ``choice``: one of ``values`` with probabilities ``weights``, int32.
    """
    kind = spec["kind"]
    if kind == "row_text":
        return decimal_text(row_ids + int(spec["base"]), int(spec["digits"]))
    if kind == "vocabulary":
        vocab = np.array(VOCABULARIES[spec["vocabulary"]](rng, spec) + [""])
        ranks = zipf_ranks(rng, len(vocab) - 1, n, float(spec["zipf_s"]), float(spec["zipf_q"]))
        ranks[rng.random(n) < float(spec.get("empty_share", 0.0))] = len(vocab) - 1
        return vocab[ranks]
    if kind == "geometric":
        v = int(spec["low"]) + rng.geometric(float(spec["p"]), n) - 1
        return np.minimum(v, int(spec["high"])).astype(np.int32)
    if kind == "choice":
        w = np.asarray(spec["weights"], dtype=np.float64)
        return np.asarray(spec["values"], dtype=np.int32)[rng.choice(len(w), n, p=w / w.sum())]
    raise ValueError(f"unknown attribute kind {kind!r}")


def make_columns(config: dict, seed: int) -> dict:
    """The configuration's rows from ``seed``: f64 ``x``, ``y``, epoch-ms
    ``t`` (None without a date attribute), the other attributes under
    ``attrs`` (in the configuration's order), the row count ``n`` (the
    feature ids are 0..n-1), and the cluster ``centres``."""
    rng = rng_for(seed, DATA_TAG)
    n = int(config["rows"])
    x, y, centres = gdelt_points(n, rng, int(config["clusters"]),
                                 tuple(config["cluster_sigma_deg"]))
    t = t0_ms(config) + rng.integers(0, span_ms(config), n) if config.get("dtg") else None
    ids = np.arange(n, dtype=np.int64)
    attrs = {name: attribute_column(spec, n, rng_for(seed, ATTR_TAG, k), ids)
             for k, (name, spec) in enumerate(config.get("attributes", {}).items())}
    return {"x": x, "y": y, "t": t, "attrs": attrs, "centres": centres, "n": n}


# -- requests ------------------------------------------------------------


@dataclass
class Request:
    """One query of a stream: what the client sends (``ecql`` and the
    projection ``transforms``, None for full features) and the parameters
    the reference reads (``box``, ``window``), as the filter parses them."""

    client: int
    seq: int
    kind: str
    ecql: str = ""
    box: tuple | None = None
    window: tuple | None = None
    transforms: tuple | None = None


def iso(ms: int) -> str:
    return f"{np.datetime64(int(ms), 'ms')}Z"


def during(field_name: str, window) -> str:
    lo, hi = window
    return f"{field_name} DURING {iso(lo)}/{iso(hi)}"


def _deck(rng, items: list):
    """Endless draws from ``items``, each pass a fresh shuffle."""
    while True:
        for k in rng.permutation(len(items)):
            yield items[k]


def _window_ms(rng, dur_ms: int, config: dict, step_ms: int = 1) -> tuple:
    """A window of ``dur_ms`` inside the data's span, its start on a
    multiple of ``step_ms`` after t0."""
    t0, span = t0_ms(config), span_ms(config)
    slots = (span - dur_ms) // step_ms
    start = t0 + step_ms * int(rng.integers(0, slots + 1))
    return start, start + dur_ms


def bbox_requests(p: dict, config: dict, rng, client: int, centres=None):
    """BBOX (+ DURING) queries: each box one of ``box_deg`` ([width,
    height] in degrees) with its corners on whole degrees, placed
    uniformly inside the lon/lat domain; each window one of
    ``window_hours``, starting on a whole ``window_step_hours`` after the
    data's t0; each query returning full features or one of
    ``transforms`` (attribute names)."""
    geom = config["geom"]
    hours = p.get("window_hours") or [None]
    projections = p.get("transforms") or [None]
    deck = _deck(rng, [(tuple(b), h, tr) for b in p["box_deg"] for h in hours
                       for tr in projections])
    step = int(p.get("window_step_hours", 1)) * HOUR_MS
    for seq, ((w, hh), h, tr) in enumerate(deck):
        qx = int(rng.integers(-180, 180 - int(w) + 1))
        qy = int(rng.integers(-90, 90 - int(hh) + 1))
        box = (float(qx), float(qy), float(qx + w), float(qy + hh))
        ecql = f"BBOX({geom}, {qx}, {qy}, {qx + int(w)}, {qy + int(hh)})"
        window = None
        if h is not None:
            window = _window_ms(rng, int(h) * HOUR_MS, config, step)
            ecql += " AND " + during(config["dtg"], window)
        yield Request(client, seq, "bbox", ecql=ecql, box=box, window=window,
                      transforms=None if tr is None else tuple(tr))


SHAPES = {"bbox": bbox_requests}


def stream(traffic: dict, config: dict, seed: int, client: int, centres, warmup=False):
    """Client ``client``'s endless request stream of a traffic mix."""
    p = traffic["request"]
    rng = rng_for(seed, WARMUP_TAG if warmup else MEASURED_TAG, client)
    return SHAPES[p["shape"]](p, config, rng, client, centres)
