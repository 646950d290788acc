"""End-to-end training with failure injection + resume.

The port of ``examples/train_resume.py``.  Trains a tiny llama, kills it
after step 18, restarts from the last atomic checkpoint (step 10) and
checks that the run continues: the loop resumes after the restored step,
so the second run trains steps 11–29 and yields 19 losses (ROADMAP.md C14;
the reference example asserts 20, which its own loop does not give).  The
data stream is the same across the restart.

    PYTHONPATH=src python -m repro_torch.examples.train_resume [--device cpu]

Runs on the card unless ``--device cpu`` (the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import main as train_main

#: The run of both phases (tiny llama, 30 steps of 4 x 64 tokens).
ARGV = ["--arch", "llama3.2-1b", "--tiny", "--steps", "30", "--batch", "4",
        "--seq", "64"]
FAIL_AT, CKPT_EVERY = 18, 10
#: The steps the resumed run trains: after the last checkpoint at or
#: before FAIL_AT, to the end.
RESUMED = range(FAIL_AT - FAIL_AT % CKPT_EVERY + 1, 30)


def main(argv=None) -> dict:
    """Both phases; returns ``{"died": the first run's result, "resumed":
    the second's}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run = ARGV + (["--device", args.device] if args.device else [])
    ckpt = ["--ckpt-every", str(CKPT_EVERY)]
    with tempfile.TemporaryDirectory() as d:
        print(f"=== phase 1: train, die at step {FAIL_AT} (ckpt every "
              f"{CKPT_EVERY}) ===")
        r1 = train_main(run + ["--ckpt-dir", d, "--fail-at", str(FAIL_AT)]
                        + ckpt)
        assert r1["died_at"] == FAIL_AT
        print(f"\n=== phase 2: restart, resume after step "
              f"{RESUMED.start - 1}, finish ===")
        r2 = train_main(run + ["--ckpt-dir", d] + ckpt)
        assert "losses" in r2 and len(r2["losses"]) == len(RESUMED)
    print("\nresume OK — training is crash-safe.")
    return {"died": r1, "resumed": r2}


if __name__ == "__main__":
    main()
