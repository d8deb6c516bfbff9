#!/usr/bin/env python3
"""Planted faults in the two attention kernels, against ``chip_smoke.py``'s
checks. Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_fault_check.py

Each fault is planted by a text substitution in a copy of ``src/repro_torch``
in a temporary directory (the checkout is left as it is); the copy builds
its kernels there, and runs in a process of its own. The faults:

* ``attention_tile``: in ``flash_attention``'s TMA/wgmma kernel (the one
  these bf16, D 128 shapes run on), q tiles from row 2,048 on skip kv tile 0
  (64 of 2,049 or more keys);
* ``decode_chunk``: in ``flash_decode``'s merge of the splits, a sequence
  of more than 16 splits (longer than 4,096 positions at the serving
  shape's splits of 256) leaves its last split out (at most 6 % of its
  positions).

For the sound kernels and for each fault, at ``chip_smoke.py``'s phase-2
serving shapes (prefill attention at S 4096 and 3001, q 16 heads and k/v 8
heads of 128, causal; decode over a 16 x 8,192 cache; bf16), it prints the
largest difference from the plain version, whether the flat 2e-2 bar of
``tests/test_kernels.py`` holds, and the share of ``chip_smoke.py``'s
output-scaled bar that the difference uses (above 1 fails). Then, at full
qwen3-1.7b width and depth with random weights from seed 0, a 4,500-token
prefill and one decode step through the kernels against the same through
the plain versions: the largest logit difference, beside ``LOGIT_TOL``.

It exits 0 when the sound kernels pass both bars and each fault fails the
scaled bar, and writes the readings to ``chiprun_out/fault_check.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FAULTS = {
    "attention_tile": (
        "flash_attention",
        "  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / kTmaBK : 0;\n",
        "  const int lo = max(p.window > 0 ? max(0, q0 - p.window + 1) / kTmaBK : 0, q0 >= 2048 ? 1 : 0);\n",
    ),
    "decode_chunk": (
        "flash_decode",
        "    for (int s = sg; s < ns; s += groups) {\n",
        "    for (int s = sg; s < ns - (ns > 16); s += groups) {\n",
    ),
}
PROMPT = 4500


def _measure(torch, smoke, got, want) -> dict:
    g, w = got.float(), want.float()
    return dict(max_abs_err=float((g - w).abs().max()),
                flat_bar_holds=bool(torch.allclose(g, w, atol=2e-2, rtol=2e-2)),
                scaled_bar_used=float(((g - w).abs() / smoke._scaled_bar(want)).max()))


def run_variant(dev_name: str = "cuda") -> dict:
    """The readings of the kernels that ``repro_torch`` (first on the path)
    builds, at the serving shapes."""
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_name)
    rng = np.random.default_rng(0)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    out = {}
    for s in (4096, 3001):
        q, k, v = bf16((1, s, 16, 128)), bf16((1, s, 8, 128)), bf16((1, s, 8, 128))
        out[f"flash_attention S={s}"] = _measure(torch, smoke, flash_attention(q, k, v),
                                                 flash_attention_ref(q, k, v))
    b, t = 16, smoke.SERVE_CACHE
    q, k, v = bf16((b, 16, 128)), bf16((b, t, 8, 128)), bf16((b, t, 8, 128))
    lengths = rng.integers(1, t, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, t + 7
    lengths = torch.from_numpy(lengths).to(dev)
    out[f"flash_decode {b}x{t}"] = _measure(torch, smoke, flash_decode(q, k, v, lengths),
                                           flash_decode_ref(q, k, v, lengths))
    del q, k, v

    cfg = get_config(smoke.SERVE_ARCH)
    model = Model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device=dev, dtype=torch.int32)
    cache_len = PROMPT + 64
    k_logits, k_state = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    with smoke._attention_versions(flash_attention_ref, flash_decode_ref):
        p_logits, p_state = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    nxt = p_logits.argmax(dim=-1).to(torch.int32)
    k_step, _ = model.decode_step(params, k_state, nxt)
    with smoke._attention_versions(flash_attention_ref, flash_decode_ref):
        p_step, _ = model.decode_step(params, p_state, nxt)
    out["model"] = dict(prefill_logit_err=float((k_logits - p_logits).abs().max()),
                        decode_logit_err=float((k_step - p_step).abs().max()),
                        logit_tol=smoke.LOGIT_TOL, prompt=PROMPT, layers=cfg.num_layers)
    return out


def _copy_with_fault(dest: Path, fault: str | None) -> Path:
    src = dest / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is not None:
        kernel, old, new = FAULTS[fault]
        cu = src / "repro_torch" / "kernels" / kernel / "csrc" / f"{kernel}.cu"
        text = cu.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{fault}: the line to change is not in {cu.name} once")
        cu.write_text(text.replace(old, new))
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_fault_check: run from a checkout (src/repro_torch missing)", file=sys.stderr)
        return 1
    readings = {}
    with tempfile.TemporaryDirectory(prefix="fault_check_") as tmp:
        for variant in (None, *FAULTS):
            name = variant or "sound"
            src = _copy_with_fault(Path(tmp) / name, variant)
            env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(src), str(ROOT)]))
            code = ("import json, chip_fault_check as f; "
                    "print('READINGS ' + json.dumps(f.run_variant()))")
            proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp,
                                  capture_output=True, text=True)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("READINGS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
                raise RuntimeError(f"variant {name} failed ({proc.returncode})")
            readings[name] = json.loads(line[0][len("READINGS "):])
            for case, r in readings[name].items():
                print(f"{name:15s} {case:26s} {json.dumps(r)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fault_check.json").write_text(json.dumps(dict(device=smi, readings=readings), indent=1))

    kernel_cases = lambda r, kernel: [v for c, v in r.items() if c.startswith(kernel)]  # noqa: E731
    ok = all(v["flat_bar_holds"] and v["scaled_bar_used"] <= 1.0
             for c, v in readings["sound"].items() if c != "model")
    sound = readings["sound"]["model"]
    ok &= max(sound["prefill_logit_err"], sound["decode_logit_err"]) <= sound["logit_tol"]
    for fault, (kernel, _, _) in FAULTS.items():
        ok &= any(v["scaled_bar_used"] > 1.0 for v in kernel_cases(readings[fault], kernel))
    print("chip_fault_check: " + ("every planted fault fails the scaled bar; the sound kernels pass"
                                  if ok else "FAILED: see the readings above"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
