"""The training driver on the ``ssm``, ``hybrid``, ``audio`` and ``vlm``
families, on the CPU (moved out of ``tests/test_torch_family_trainer.py``
so that the two files spread over the test workers):
``python -m repro_torch.launch.train`` trains rwkv6-1.6b and
recurrentgemma-2b (the loss falls); whisper-base and llava-next-34b fail
with the reference's ``KeyError`` (its pipeline gives tokens and targets
only), which the reference's own driver raises too."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _driver(module, arch, *extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, "--arch", arch, *extra], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)


@pytest.mark.parametrize("arch,seq", [("rwkv6-1.6b", "64"), ("recurrentgemma-2b", "96")])
def test_train_driver_trains_the_recurrent_families(arch, seq):
    proc = _driver("repro_torch.launch.train", arch, "--device", "cpu", "--steps", "6", "--seq", seq,
                   "--batch", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch} family=") and "devices=1" in lines[0]
    done = [ln for ln in lines if ln.startswith("done: loss ")]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert np.isfinite(first) and last < first, done
    assert lines[-1].startswith("hot-row embedding hit rate (EMA traffic): ")


@pytest.mark.parametrize("arch,key", [("whisper-base", "frames"), ("llava-next-34b", "patches")])
def test_train_driver_fails_on_audio_and_vlm_as_the_reference_does(arch, key):
    port = _driver("repro_torch.launch.train", arch, "--device", "cpu", "--steps", "2")
    ref = _driver("repro.launch.train", arch, "--steps", "2")
    for proc in (port, ref):
        assert proc.returncode != 0
        assert f"KeyError: '{key}'" in proc.stderr, proc.stderr[-2000:]
