"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``
(counterpart of ``src/repro/launch/serve.py``).

Spins up a batched decode engine on the reduced config of any of the
reference's ten architectures (``--arch``), drives it with a
Zipf stream of session requests through the Redynis session router (the
paper's workload, serving flavour), and reports throughput and the
router's local-hit rate and migration volume. ``--fail-pod`` kills a pod
half-way to show the leader re-election (paper §11). It runs on the card;
``--device cpu`` runs the plain versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import build
from repro_torch.serving import Request, ServeEngine, SessionRouter
from repro_torch.serving.kvcache import state_bytes

__all__ = ["serve_loop", "main"]


def serve_loop(engine, router, rng: np.random.Generator, *, requests: int, sessions: int,
               pods: int, prompt_len, max_new: int, vocab_size: int, fail_pod: int = -1,
               prompt_step: int = 1, log=print) -> float:
    """The launcher's loop: each request picks a session by Zipf-1.2
    popularity from its home pod ``i % pods``, is routed, is prefilled into
    a lane unless its session holds one, and every request advances the
    engine one step and the router one tick. ``prompt_len`` is a length or
    an inclusive ``(lo, hi)`` range drawn uniformly per prompt, in steps of
    ``prompt_step`` from ``lo`` (an RWKV-6 prompt of 32 tokens or more must
    be a multiple of 32: pass ``lo`` a multiple of 32 and a step of 32).
    Ends with ``run_to_completion``; returns the wall seconds (the card is
    synchronised first)."""
    home = {f"s{i}": i % pods for i in range(sessions)}
    ranks = np.arange(1, sessions + 1, dtype=np.float64) ** -1.2
    popularity = ranks / ranks.sum()
    t0 = time.perf_counter()
    for i in range(requests):
        sid = f"s{rng.choice(sessions, p=popularity)}"
        router.route(sid, home[sid])
        if engine.lanes.lookup(sid) is None:
            if isinstance(prompt_len, int):
                n = prompt_len
            else:
                lo, hi = prompt_len
                n = lo + prompt_step * int(rng.integers(0, (hi - lo) // prompt_step + 1))
            prompt = rng.integers(0, vocab_size, n)
            engine.admit(Request(session=sid, tokens=prompt, max_new=max_new))
        engine.step()
        router.tick()
        if fail_pod >= 0 and i == requests // 2:
            log(f"!! killing pod {fail_pod} (leader={router.leader})")
            router.fail_pod(fail_pod)
    engine.run_to_completion()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--fail-pod", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    model = build(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    engine = ServeEngine(model, params, num_lanes=args.lanes, cache_len=256)
    router = SessionRouter(
        num_pods=args.pods,
        max_sessions=args.sessions * 2,
        sweep_period=16,
        session_bytes=state_bytes(engine.state) / args.lanes,
        device=device,
    )
    dt = serve_loop(
        engine, router, np.random.default_rng(args.seed), requests=args.requests,
        sessions=args.sessions, pods=args.pods, prompt_len=args.prompt_len,
        max_new=args.max_new, vocab_size=cfg.vocab_size, fail_pod=args.fail_pod,
    )
    print(
        f"served {engine.tokens_out} tokens in {dt:.2f}s "
        f"({engine.tokens_out / dt:.1f} tok/s on {device.type}, reduced config)"
    )
    print(
        f"router: hit_rate={router.hit_rate():.3f} "
        f"migrations={router.stats['migrations']} "
        f"migrated={router.stats['migrated_bytes'] / 1e6:.1f}MB "
        f"elections={router.stats['elections']} leader={router.leader}"
    )


if __name__ == "__main__":
    main()
