"""Runnable end-to-end examples: the ports of the reference's examples/,
under the same names. Each has ``main(device="cuda", record=None)``; see
README.md beside them."""


def cli_device(argv=None) -> str:
    """The ``--device`` of an example's command line (default cuda)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv).device
