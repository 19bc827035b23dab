"""The port's mesh dry-run (``repro_torch.launch.dryrun``) on fake
worlds of CPU ranks, and the roofline table over its artifacts.

Every reduced arch and every shape (``dryrun.reduced_shape``) runs on a
fake 2x2 (data, model) world: ``ok``, or ``skipped`` exactly where the
JAX package's ``cell_supported`` skips (``long_500k`` on pure full
attention).  The other five archs are in ``test_torch_dryrun_mixed.py``
(one pytest-xdist worker takes a file).  ``repro.launch.dryrun`` is never
imported here (it sets ``XLA_FLAGS`` at import); its skip rule and JSON
keys are restated from its source.
"""

import json

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline

ARCHS = ["internlm2_1_8b", "phi3_medium_14b", "qwen3_8b", "granite_34b",
         "qwen2_vl_72b"]
# repro/launch/dryrun.py's result keys, lower_s / compile_s -> trace_s
JAX_OK_KEYS = {"cell", "status", "lower_s", "compile_s", "n_devices",
               "memory", "roofline", "model_flops_global",
               "model_flops_per_device", "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "peak_bytes_per_device"}


def jax_skips(arch: str, shape: str) -> bool:
    """repro.launch.dryrun.cell_supported, on the JAX package's config."""
    return shape == "long_500k" \
        and not jax_get_config(arch).supports_long_context


def check_cell(r: dict, arch: str, shape: str, multi_pod: bool = False):
    mesh = "multipod" if multi_pod else "singlepod"
    assert r["cell"] == f"{arch}/{shape}/{mesh}"
    if jax_skips(arch, shape):
        assert r["status"] == "skipped", r
        assert set(r) == {"cell", "status", "reason"}
        return
    assert r["status"] == "ok", r.get("traceback", r)
    assert set(r) == JAX_OK_KEYS - {"lower_s", "compile_s"} | {"trace_s"}
    assert set(r["memory"]) == MEMORY_KEYS
    assert r["n_devices"] == (8 if multi_pod else 4)
    roof = r["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["coll_bytes"] > 0           # a sharded step communicates
    assert r["memory"]["peak_bytes_per_device"] >= \
        r["memory"]["argument_bytes"] > 0
    assert r["model_flops_per_device"] * r["n_devices"] \
        == r["model_flops_global"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_on_fake_2x2(arch, shape):
    r = dryrun.run_cell(arch, shape, save=False, reduced=True, device="cpu",
                        mesh_shape=(2, 2))
    check_cell(r, arch, shape)


def test_cell_supported_matches_jax():
    for arch in ARCHS + ["zamba2_2_7b", "mixtral_8x22b", "xlstm_1_3b",
                         "whisper_medium", "granite_moe_3b_a800m"]:
        for shape in SHAPES:
            ok, why = dryrun.cell_supported(get_config(arch), SHAPES[shape])
            assert ok != jax_skips(arch, shape)
            assert bool(why) == (not ok)


def test_meshes_have_jax_shapes_and_names():
    """``launch.mesh``'s meshes on fake worlds: repro/launch/mesh.py's
    shapes and axis names."""
    from repro_torch.launch import mesh as M
    with M.fake_world(256):
        m = M.make_production_mesh(device_type="cpu")
        assert (m.shape, m.mesh_dim_names) == ((16, 16), ("data", "model"))
        ep = M.make_ep_mesh(8, device_type="cpu")
        assert (ep.shape, ep.mesh_dim_names) == ((16, 8, 2),
                                                 ("data", "expert", "model"))
        with pytest.raises(ValueError):
            M.make_ep_mesh(3, device_type="cpu")
    with M.fake_world(512):
        m = M.make_production_mesh(multi_pod=True, device_type="cpu")
        assert (m.shape, m.mesh_dim_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    with M.fake_world(1):
        m = M.make_local_mesh("cpu")
        assert (m.shape, m.mesh_dim_names) == ((1, 1), ("data", "model"))


def test_artifacts_and_roofline_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(roofline, "ARTIFACTS", tmp_path)
    for shape in ("prefill_32k", "long_500k"):
        dryrun.run_cell("qwen3_8b", shape, reduced=True, device="cpu",
                        mesh_shape=(2, 2))
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["qwen3_8b__long_500k__singlepod.json",
                     "qwen3_8b__prefill_32k__singlepod.json"]
    rows = roofline.load("singlepod")
    assert [d["status"] for d in rows] == ["skipped", "ok"]
    table = roofline.fmt_table(rows)
    assert "qwen3_8b/prefill_32k" in table and "skipped" in table
    assert "fit80G" not in table and table.splitlines()[0].endswith("fit")
    md = roofline.fmt_table(rows, markdown=True)
    assert md.splitlines()[0].endswith("fit80G |")
    roofline.main(["--hints"])
    out = capsys.readouterr().out
    assert "qwen3_8b/prefill_32k" in out and "->" in out
    ok = json.loads((tmp_path / files[1]).read_text())
    assert ok["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_roofline_without_artifacts_names_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "ARTIFACTS", tmp_path)
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun"):
        roofline.main([])


@pytest.mark.parametrize("failing", [None, "qwen3_8b/train_4k"])
def test_all_exits_nonzero_on_an_error(failing, monkeypatch, capsys):
    """``--all`` runs every cell and exits 1 when any is an error, 0
    otherwise (``run_cell`` replaced by a stand-in: no cell is traced)."""
    seen = []

    def fake_run_cell(arch, shape, *, multi_pod=False, device="cuda"):
        seen.append((arch, shape, multi_pod, device))
        status = "error" if f"{arch}/{shape}" == failing else "ok"
        return {"cell": f"{arch}/{shape}", "status": status}
    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--multi-pod", "--device", "cpu"])
    assert e.value.code == (1 if failing else 0)
    assert len(seen) == 40 and all(s[2] and s[3] == "cpu" for s in seen)
    summary = capsys.readouterr().out.splitlines()[-1]
    assert summary == ("# dry-run summary: ok=39 skipped=0 errors=1"
                       if failing else
                       "# dry-run summary: ok=40 skipped=0 errors=0")
