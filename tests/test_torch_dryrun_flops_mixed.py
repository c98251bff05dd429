"""FLOP parity of the dry run, the encoder-decoder, VLM and hybrid
configurations: each cell's step traced on ``meta`` at
``scaled_down()``, B=2, S=64, counted from the port's op log, against
the reference's ``analyze_hlo`` of the same step compiled by XLA on one
CPU device, rtol 1e-6. The helpers and the rest of the dry run's tests
are in ``test_torch_dryrun.py``; the configurations are split over three
files so that no file's XLA compiles take half a minute.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from test_torch_dryrun import KINDS, assert_flop_parity  # noqa: E402

ARCHS = ("whisper-base", "internvl2-2b", "recurrentgemma-9b")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_flops_equal_the_references_hlo_analysis(name, kind):
    assert_flop_parity(name, kind)
