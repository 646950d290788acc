"""Window-scheduled serving of a real (tiny) model.

The port of ``examples/serve_continuous_batching.py``: the three admission
policies on the same engine (the paper's spin / sleep / static-vs-mutable
comparison, on batch admission), through
:func:`repro_torch.launch.serve.main`.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching [--device cpu]

Runs on the card unless ``--device cpu`` (the plain PyTorch versions).
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main

POLICIES = ("zero", "max", "mutable")
REQUESTS = 12


def main(argv=None) -> dict:
    """Serve :data:`REQUESTS` requests under each policy; returns
    ``{policy: the stats summary}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    out = {}
    for policy in POLICIES:
        print(f"\n=== policy: {policy} ===")
        out[policy] = serve_main(["--arch", "llama3.2-1b", "--tiny",
                                  "--requests", str(REQUESTS), "--slots", "3",
                                  "--max-new", "6", "--policy", policy]
                                 + device)
    return out


if __name__ == "__main__":
    main()
