"""One train step of the port against the reference's on the CPU for the
recurrent (mamba2-1.3b, recurrentgemma-2b), MoE (moonshot-v1-16b-a3b,
llama4-scout-17b-a16e) and encoder-decoder (whisper-tiny, with seeded
``enc_frames``) smoke configs; the attention archs are in
``test_torch_train_step.py``, whose docstring states the set-up.
Tolerances: ``tests/train_parity.py`` (recurrentgemma's moments and
parameters at 1e-2 of the largest, its gnorm at 1e-3)."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from train_parity import check_step, step_both                 # noqa: E402

MIXER_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "moonshot-v1-16b-a3b",
               "llama4-scout-17b-a16e", "whisper-tiny")


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_train_step_matches_reference(arch):
    ref, port, before = step_both(arch)
    check_step(arch, ref, port, before)
