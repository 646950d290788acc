"""Serving driver: continuous batching with the window-tuned standby pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --tiny --device cpu --requests 24 --slots 4

Any decoder-only arch of the catalog serves (``--arch rwkv6-1.6b``,
``--arch jamba-1.5-large-398b --tiny``, ...).  An encoder-decoder arch
(whisper) is refused with a ``ValueError``: the reference's
``DecodeEngine`` feeds its prefill no frames, so its CLI cannot serve one
either; call ``repro_torch.models.prefill`` with ``{"tokens", "frames"}``
and ``decode_step`` instead.

The port of ``repro/launch/serve.py``: the same options, plus ``--device``
(default: the card; ``cpu`` runs the plain PyTorch versions), ``--seed``
(random parameters from a ``torch.Generator`` on the device, and the
prompts) and ``--prompt-min`` / ``--prompt-max`` (prompt lengths drawn from
``[min, max)``, the reference's 4 and 12 by default).  It runs the REAL
model under the :class:`~repro_torch.serve.scheduler.ContinuousBatcher` —
the paper's technique deciding how many requests to keep prefilled ahead —
and prints the served tokens, tokens/s and the window trace.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import base as cbase
from repro_torch.configs import catalog
from repro_torch.core.oracle import EvalSWS, FixedOracle
from repro_torch.device import resolve_device
from repro_torch.serve import ContinuousBatcher, DecodeEngine, Request


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--policy", default="mutable",
                    choices=["mutable", "zero", "max"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=12)
    return ap.parse_args(argv)


def build(args, cfg=None):
    """(cfg, engine): the configuration (``args.arch``'s unless ``cfg`` is
    given, e.g. a cut of it) and a :class:`DecodeEngine` over random
    parameters drawn on the device from ``args.seed``."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = cbase.get_config(args.arch)
        if args.tiny:
            cfg = catalog.tiny(cfg)
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: the serving engine feeds "
            f"its prefill no frames (as the reference's DecodeEngine); "
            f"call repro_torch.models.prefill(cfg, params, {{'tokens', "
            f"'frames'}}) and decode_step directly")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = models.init_params(cfg, gen, device)
    return cfg, DecodeEngine(cfg, params, max_slots=args.slots,
                             max_seq=args.max_seq, device=device)


def run(args, cfg, engine) -> dict:
    """Submit ``args.requests`` requests with seeded random prompts, drain
    the batcher; returns the stats summary, the requests and the host
    seconds of the drain."""
    oracle = {"mutable": EvalSWS(k=10), "zero": FixedOracle(),
              "max": FixedOracle()}[args.policy]
    initial = {"mutable": 1, "zero": 0, "max": args.slots}[args.policy]
    bat = ContinuousBatcher(engine, max_standby=args.slots, initial=initial,
                            oracle=oracle)
    rng = np.random.default_rng(args.seed)
    reqs = []
    t0 = time.time()
    for i in range(args.requests):
        prompt = list(rng.integers(2, cfg.vocab_size - 1,
                                   size=int(rng.integers(args.prompt_min,
                                                         args.prompt_max))))
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=args.max_new,
                            arrived_at=time.time()))
        bat.submit(reqs[-1])
    stats = bat.run_until_drained(max_steps=5000)
    return {"summary": stats.summary(), "stats": stats, "requests": reqs,
            "seconds": time.time() - t0}


def main(argv=None):
    args = parse_args(argv)
    cfg, engine = build(args)
    out = run(args, cfg, engine)
    s, dt, stats = out["summary"], out["seconds"], out["stats"]
    toks = s["completed"] * args.max_new
    print(f"served {s['completed']} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {engine.device}")
    print(f"late-handoff rate {s['late_handoff_rate']:.3f}  "
          f"avg standby {s['avg_standby']:.2f}  "
          f"window trace tail {stats.window_trace[-8:]}")
    return s


if __name__ == "__main__":
    main()
