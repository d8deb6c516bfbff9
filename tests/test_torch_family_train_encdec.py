"""The loss and gradient cases of the ``audio`` (whisper-base, at its
reduced defaults and padded) and ``vlm`` (llava-next-34b) families against
the reference's, each at f32 without and with remat and at bf16 with remat:
``tests/test_torch_family_train.py``'s ``check_family_loss`` and bars (its
module docstring), in a file of their own so that the cases spread over
the test workers."""

import pytest

pytest.importorskip("torch")

from test_torch_family_train import CASES, PRECISIONS, HERE, check_family_loss  # noqa: E402

THERE = tuple(c for c in CASES if c not in HERE)


@pytest.mark.parametrize("precision,remat", PRECISIONS)
@pytest.mark.parametrize("case", THERE)
def test_family_loss_and_grads_match_jax(case, precision, remat):
    check_family_loss(case, precision, remat)
