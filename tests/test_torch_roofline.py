"""The port's roofline arithmetic and dry-run registry (``launch/roofline.py``,
``configs/registry.py``) against the JAX package's, exactly:

* ``param_counts`` and ``model_flops`` of all ten archs at all four shapes
  on both production meshes;
* ``ideal_decode_bytes_per_chip`` of every supported decode cell (the
  params and the decode cache read once);
* ``analyze_record`` and ``render_markdown``, handed the JAX package's v5e
  peaks (read from ``repro.launch.roofline`` here), give the reference's
  rows and table on the same records (records in the reference's form: no
  in-node / across-node split, so every payload takes the one link);
* ``get_shape``, ``cell_supported``, ``all_cells`` and ``SUBQUADRATIC``.
"""
import dataclasses

import pytest

import repro.configs.registry as jax_registry
import repro.launch.roofline as jax_roofline
from repro_torch.configs import registry
from repro_torch.launch import roofline

CHIPS = (256, 512)
REF_PEAKS = roofline.Peaks("TPU v5e (the JAX package's)", jax_roofline.PEAK_FLOPS,
                           jax_roofline.HBM_BW, jax_roofline.ICI_BW, jax_roofline.ICI_BW)


def test_registry_matches_the_jax_package():
    assert registry.all_cells() == jax_registry.all_cells()
    assert registry.SUBQUADRATIC == jax_registry.SUBQUADRATIC
    for arch, shape in registry.all_cells():
        assert registry.cell_supported(arch, shape) == jax_registry.cell_supported(arch, shape)
    for name in jax_registry.SHAPES:
        assert dataclasses.asdict(registry.get_shape(name)) == \
            dataclasses.asdict(jax_registry.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        registry.get_shape("train_8k")


@pytest.mark.parametrize("arch", list(jax_registry.ARCHS))
def test_param_counts_and_model_flops_match(arch):
    assert roofline.param_counts(arch) == jax_roofline.param_counts(arch)
    for name in jax_registry.SHAPES:
        s = jax_registry.get_shape(name)
        for chips in CHIPS:
            assert roofline.model_flops(arch, s.kind, s.seq_len, s.global_batch, chips) == \
                jax_roofline.model_flops(arch, s.kind, s.seq_len, s.global_batch, chips)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s in jax_registry.all_cells()
                                        if jax_registry.get_shape(s).kind == "decode"
                                        and jax_registry.cell_supported(a, s)[0]])
def test_ideal_decode_bytes_match(arch, shape):
    for chips in CHIPS:
        assert roofline.ideal_decode_bytes_per_chip(arch, shape, chips) == \
            jax_roofline.ideal_decode_bytes_per_chip(arch, shape, chips)


def _records() -> list:
    """Records in the reference's form, one of each shape kind and a skip."""
    def rec(arch, shape, mesh, chips, flops, by, fused, coll):
        return {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
                "hlo": {"flops_per_device": flops, "bytes_per_device": by,
                        "bytes_fused_per_device": fused, "collective_bytes_per_device": coll,
                        "collectives": {"all-gather": 3}}}
    return [rec("qwen3-14b", "train_4k", "16x16", 256, 3.1e15, 9.0e12, 2.5e11, 4.0e10),
            rec("smollm-135m", "prefill_32k", "2x16x16", 512, 4.0e13, 5.0e11, 6.0e10, 1.0e8),
            rec("stablelm-1.6b", "decode_32k", "16x16", 256, 2.0e10, 3.0e10, 7.0e9, 2.0e6),
            rec("rwkv6-3b", "long_500k", "16x16", 256, 6.0e9, 2.0e9, 9.0e8, 5.0e9),
            {"arch": "qwen3-14b", "shape": "long_500k", "skipped": "quadratic"}]


def test_analyze_record_and_render_match_with_the_reference_peaks():
    rows, ref_rows = [], []
    for rec in _records():
        row = roofline.analyze_record(rec, REF_PEAKS)
        ref = jax_roofline.analyze_record(rec)
        assert (row is None) == (ref is None)
        if ref is None:
            continue
        for f in dataclasses.fields(ref):
            assert getattr(row, f.name) == getattr(ref, f.name), f.name
        assert row.score == ref.score and row.useful_ratio == ref.useful_ratio
        rows.append(row)
        ref_rows.append(ref)
    assert roofline.render_markdown(rows) == jax_roofline.render_markdown(ref_rows)


def test_h100_peaks_and_the_split_collective_term():
    """The default peaks are the H100's datasheet figures; a port record's
    in-node payload crosses NVLink (450 GB/s each way), the rest the NIC."""
    assert roofline.H100.flops == 989e12 and roofline.H100.hbm == 3.35e12
    assert roofline.H100.link_in_node == 450e9 and roofline.H100.link_across_nodes == 50e9
    hlo = {"collective_bytes_per_device": 5e9, "collective_bytes_in_node_per_device": 4.5e9,
           "collective_bytes_across_nodes_per_device": 0.5e9}
    assert roofline.collective_seconds(hlo) == pytest.approx(4.5e9 / 450e9 + 0.5e9 / 50e9)
    rec = dict(_records()[0], hlo={**_records()[0]["hlo"], **hlo})
    row = roofline.analyze_record(rec)
    assert row.compute_s == 3.1e15 / 989e12 and row.memory_s == 2.5e11 / 3.35e12
    assert row.dominant == "compute"
