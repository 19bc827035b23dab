"""The mesh dry-run on a fake 2x2x2 (pod, data, model) world: the
multi-pod mesh, the batch over ("pod", "data"), one cell per family and
kind (a trace on a three-dim mesh costs several times a two-dim one's;
the full-size multi-pod train cell runs on the GPU machine, through
``chip_smoke.py``).  See ``test_torch_dryrun.py``."""

import pytest

from repro_torch.launch import dryrun

from test_torch_dryrun import check_cell

MULTI_POD = [("qwen2_vl_72b", "train_4k"), ("qwen3_8b", "prefill_32k"),
             ("mixtral_8x22b", "decode_32k"), ("whisper_medium", "decode_32k"),
             ("zamba2_2_7b", "long_500k"), ("xlstm_1_3b", "long_500k"),
             ("phi3_medium_14b", "long_500k")]


@pytest.mark.parametrize("arch,shape", MULTI_POD)
def test_multi_pod_cell_on_fake_2x2x2(arch, shape):
    r = dryrun.run_cell(arch, shape, multi_pod=True, save=False,
                        reduced=True, device="cpu", mesh_shape=(2, 2, 2))
    check_cell(r, arch, shape, multi_pod=True)
