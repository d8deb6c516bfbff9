"""The serving launcher for the four families of this slice —
rwkv6-1.6b, recurrentgemma-2b, whisper-base and llava-next-34b — against
the JAX reference's launcher on the CPU, on the same arguments: its
router line (hit rate, migrations, the bytes they move, which is the
decode state's bytes over the lanes, elections) and its token count,
each exact."""

import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "whisper-base", "llava-next-34b"]


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu_matches_jax_router_line(arch, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch <id>`` runs
    the whole path; its router line (hit rate, migrations, the bytes they
    move, elections after the leader fails) and its token count equal the
    reference launcher's on the same arguments."""
    args = ["--arch", arch, "--requests", "40", "--sessions", "12", "--lanes", "4", "--max-new", "4",
            "--fail-pod", "3"]
    serve.main(args + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == theirs[0] == "!! killing pod 3 (leader=3)"
    assert ours[-1] == theirs[-1] and "elections=1" in ours[-1]
    assert "migrations=0 " not in ours[-1]
    assert ours[1].split(" in ")[0] == theirs[1].split(" in ")[0]  # tokens served
