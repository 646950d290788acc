#!/usr/bin/env python3
"""K5 (``flash_attention``) at the served models' prefill layers on one
CUDA card: this checkout's kernels beside another checkout's, in turns.

    git archive <commit> | tar -x -C build/parent   # build/ is git-ignored
    python3 tools/k5_versus_parent.py --parent build/parent

Each turn is a process of its own that loads one checkout's
``chip_smoke.py`` (which puts that checkout's ``src`` first on
``sys.path``; its LM library builds into that checkout's ``build/``) and
calls its ``flash_entry`` at each layer of :data:`LAYERS`: the entry of
the ``kernels`` line, timed, bounded and checked against the plain version
as ``chip_smoke.py`` does it, with the kernel the launch took (the
tensor-core one or the SIMT one, by ``tc_launches``).  The turns run
parent, this, this, parent, so that a drift of the card shows as a
difference between a side's two turns.  Prints the card's name and power
limit, one JSON line per turn, and a last JSON line with every layer's
device ms side by side.  Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, B*H, B*KV, S, hd, causal): the prefill layers of gemma3-4b and
#: stablelm-3b at 1024 tokens, then llama3.2-1b's, jamba's and whisper's
#: encoder layer at 8 clips of 1500 frames.
LAYERS = (("gemma3-4b", 8, 4, 1024, 256, True),
          ("stablelm-3b", 32, 32, 1024, 80, True),
          ("llama3.2-1b", 32, 8, 1024, 64, True),
          ("jamba", 64, 8, 1024, 128, True),
          ("whisper", 160, 160, 1500, 64, False))


def side(tree):
    """One turn: K5 of the checkout at ``tree``, by its own
    ``chip_smoke.flash_entry``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.abspath(tree), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = cs.torch.Generator(device=cs.DEV).manual_seed(2)
    out = {"tree": tree, "layers": {}}
    for name, BH, BKV, S, hd, causal in LAYERS:
        tc = cs.LMA.tc_launches
        entry = cs.flash_entry(name, "k5_versus_parent", 0, 0, 0.0, BH, BKV,
                               S, hd, gen, causal=causal)
        entry["kernel"] = ("tensor_core" if cs.LMA.tc_launches > tc
                           else "simt")
        out["layers"][name] = entry
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the checkout to compare with")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        print(json.dumps(side(args.side)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = [("this", HERE)]
    if args.parent:
        turns = [("parent", args.parent), ("this", HERE), ("this", HERE),
                 ("parent", args.parent)]
    runs = []
    for label, tree in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--side", tree]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            sys.exit(f"k5_versus_parent: the {label} turn failed")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["side"] = label
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    table = {name: {f"{r['side']}_{i}": {
                 k: r["layers"][name][k]
                 for k in ("kernel", "ms", "library_ms", "bound_ms")}
             for i, r in enumerate(runs)} for name, *_ in LAYERS}
    print(json.dumps({"k5_versus_parent": table}))


if __name__ == "__main__":
    main()
