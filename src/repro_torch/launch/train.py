"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--full]`` (counterpart of ``src/repro/launch/train.py``).

By default it trains the reduced config of the architecture; ``--full``
takes the architecture at full size. The Redynis daemons (expert placement
and the hot-row embedding cache) run inside the loop whenever the
architecture enables them. It runs on the card; ``--device cpu`` runs the
plain versions of the kernels on the CPU. Every id of ``ARCH_IDS`` is
taken; the pipeline gives tokens and targets only, as the reference's does,
so the audio and vlm families (whisper-base, llava-next-34b) stop at their
first step with the reference driver's ``KeyError`` (``frames``,
``patches``): they train through ``Model.loss`` and ``Trainer.step`` on a
``Model.make_batch`` batch.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main"]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build(cfg, dev)
    print(f"arch={cfg.name} family={cfg.family} params={model.num_params()/1e6:.1f}M "
          f"active={model.active_params()/1e6:.1f}M devices={devices}")

    trainer = Trainer(
        model,
        TrainConfig(
            opt=OptConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5 + 1), total_steps=args.steps),
            microbatches=args.microbatches,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
        ),
        num_nodes=max(devices, 1),
    )
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                               seed=args.seed), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = trainer.restore(gen) if args.checkpoint_dir else trainer.init_state(gen)
    state, hist = trainer.run(state, pipe, args.steps)
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over {len(hist)} steps")
    if state.expert_placement is not None:
        hr = float(trainer.expert_daemon.hit_rate(state.expert_placement))
        print(f"expert replica hit rate (EMA traffic): {hr:.3f}")
    if state.hot_embed is not None:
        hr = float(trainer.embed_daemon.hit_rate(state.hot_embed))
        print(f"hot-row embedding hit rate (EMA traffic): {hr:.3f}")


if __name__ == "__main__":
    main()
