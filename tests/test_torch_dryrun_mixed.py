"""The mesh dry-run for the other five archs (hybrid, MoE, SSM, audio) on
a fake 2x2 world.  See ``test_torch_dryrun.py``."""

import pytest

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun

from test_torch_dryrun import check_cell

ARCHS = ["zamba2_2_7b", "mixtral_8x22b", "granite_moe_3b_a800m",
         "xlstm_1_3b", "whisper_medium"]



@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_on_fake_2x2(arch, shape):
    r = dryrun.run_cell(arch, shape, save=False, reduced=True, device="cpu",
                        mesh_shape=(2, 2))
    check_cell(r, arch, shape)

