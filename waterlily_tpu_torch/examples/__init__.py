"""Runnable examples of the port, twins of the JAX package's
``examples/``: ``python -m waterlily_tpu_torch.examples.<name>`` with
``--device`` (default ``cuda``) and ``--quick`` (a reduced run):
`three_d_sphere`, `two_d_circle` (``--gif``), `oscillating_plate`,
`optimize_spin` (``--implicit``), `ensemble_sweep` (``--members``,
``--dm``) and `sharded_sphere` (``--ranks``, ``--backend``: the process
mesh).  Each module's ``main(argv)`` returns what it printed, for
tests."""
import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """The examples' common arguments: ``--device`` and ``--quick``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of every field (default cuda)")
    p.add_argument("--quick", action="store_true",
                   help="a reduced run (a smaller grid, fewer samples)")
    return p
