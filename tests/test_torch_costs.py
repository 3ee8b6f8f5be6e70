"""The port's cost model and mesh (``repro_torch.launch.costs`` and
``.mesh``) against the reference's (``repro.launch.costs``).

``step_costs`` is the reference's model, so the port's must equal it
float for float: every arch x input shape x ``long_mode``, all four
fields compared with ``==``.  The reference's own checks of the model
(tests/test_costs_and_parse.py, all but its HLO parser's, which has no
twin) run again on the port.  The mesh holds the H100's peaks and no TPU
constant, and its functions describe the one card.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.launch import costs as jcosts
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import costs, mesh


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_equal_the_reference(arch, shape):
    for long_mode in (False, True):
        got = costs.step_costs(get_config(arch), SHAPES[shape], long_mode)
        want = jcosts.step_costs(jconfigs.get_config(arch),
                                 jconfigs.SHAPES[shape], long_mode)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (arch, shape, long_mode)
        assert [type(v) for v in dataclasses.astuple(got)] == \
            [type(v) for v in dataclasses.astuple(want)]


def test_train_flops_close_to_6nd():
    cfg = get_config("qwen2-0.5b")
    shape = SHAPES["train_4k"]
    c = costs.step_costs(cfg, shape)
    six_nd = 6.0 * cfg.active_param_count() * shape.global_batch \
        * shape.seq_len
    # remat adds ~+2ND, attention a bit more: ratio in [1.0, 2.5]
    assert 1.0 <= c.flops / six_nd <= 2.5


def test_moe_uses_active_params():
    cfg = get_config("deepseek-v2-236b")
    shape = SHAPES["train_4k"]
    c = costs.step_costs(cfg, shape)
    six_nd_total = 6.0 * cfg.param_count() * shape.global_batch \
        * shape.seq_len
    assert c.flops < 0.5 * six_nd_total      # top-6 of 160 experts


def test_decode_memory_bound_by_weights_and_cache():
    cfg = get_config("qwen2.5-32b")
    shape = SHAPES["decode_32k"]
    c = costs.step_costs(cfg, shape)
    assert c.hbm_bytes >= cfg.param_count() * 2 * 0.9   # bf16 weights read
    assert c.cache_bytes > 0
    # decode flops tiny vs train
    c_train = costs.step_costs(cfg, SHAPES["train_4k"])
    assert c.flops < 1e-3 * c_train.flops


def test_sliding_window_reduces_attention_flops():
    cfg = get_config("gemma2-2b")
    pre = SHAPES["prefill_32k"]
    full = costs.step_costs(cfg.replace(sliding_window=0), pre)
    swa = costs.step_costs(cfg, pre)
    assert swa.flops < full.flops


def test_mamba_decode_cache_constant_in_seq():
    cfg = get_config("mamba2-130m")
    c32 = costs.step_costs(cfg, SHAPES["decode_32k"])
    c500 = costs.step_costs(cfg, SHAPES["long_500k"], long_mode=True)
    # SSM state is O(1) in sequence length (per sequence)
    per_seq_32 = c32.cache_bytes / SHAPES["decode_32k"].global_batch
    per_seq_500 = c500.cache_bytes / SHAPES["long_500k"].global_batch
    assert abs(per_seq_32 - per_seq_500) / per_seq_32 < 1e-6


def test_mla_cache_much_smaller_than_gqa():
    ds = get_config("deepseek-v2-236b")
    c = costs.step_costs(ds, SHAPES["decode_32k"])
    # MLA latent cache: (512+64) per position vs 128 heads * 128 * 2
    naive = ds.num_layers * 128 * 32768 * 2 * 128 * 128 * 2
    assert c.cache_bytes < 0.05 * naive


def test_mesh_holds_the_h100_and_no_tpu_constant():
    """The H100 SXM's data-sheet peaks; none of the reference's TPU v5e
    constants (its 197 TFLOP/s, 819 GB/s, the per-link ICI rate)."""
    from repro.launch import mesh as jmesh

    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.HBM_BYTES) == (989e12, 67e12, 3.35e12, 85_017_493_504)
    assert not hasattr(mesh, "ICI_BW_PER_LINK")
    ours = {v for k, v in vars(mesh).items() if k.isupper()}
    tpu = {v for k, v in vars(jmesh).items() if k.isupper()}
    assert not ours & tpu


def test_mesh_functions_describe_the_one_card():
    prod = mesh.make_production_mesh()
    assert prod.shape == (1, 1) and prod.axis_names == ("data", "model")
    assert mesh.num_chips(prod) == 1
    with pytest.raises(ValueError, match="512"):
        mesh.make_production_mesh(multi_pod=True)
    dbg = mesh.make_debug_mesh(4, 2)
    assert dbg.shape == (4, 2) and dbg.axis_names == ("data", "model")
    assert mesh.num_chips(dbg) == 1
    assert mesh.make_debug_mesh().shape == (2, 2)


@pytest.mark.parametrize("spec,mode,shape,said", [
    ("4x1", "admm", (4, 1), ""),
    ("4x2", "admm", (4, 2), "mesh 4x2: the model axis (2) is unused on "
                            "one card; computing 4x1"),
    ("2x1", "allreduce", (2, 1), "mesh 2x1: unused under allreduce")])
def test_parse_mesh_reads_dxm(spec, mode, shape, said, capsys):
    got = mesh.parse_mesh(spec, mode)
    assert got.shape == shape and got.axis_names == ("data", "model")
    printed = capsys.readouterr().out
    assert said in printed and bool(printed) == bool(said)


@pytest.mark.parametrize("name,chips", [("single", "256"), ("multi", "512")])
def test_parse_mesh_refuses_the_reference_meshes(name, chips):
    with pytest.raises(SystemExit, match=chips):
        mesh.parse_mesh(name, "admm")


def test_chip_smoke_takes_its_peaks_from_the_mesh():
    """chip_smoke.py's bound uses the mesh's HBM and fp32 rates."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {(n.module, a.name, a.asname) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert ("repro_torch.launch.mesh", "HBM_BW", "HBM_BYTES_S") in imported
    assert ("repro_torch.launch.mesh", "PEAK_FLOPS_F32",
            "FP32_FLOP_S") in imported
    assigned = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not {"HBM_BYTES_S", "FP32_FLOP_S"} & assigned
