"""The roofline's pieces against the JAX package's: the active parameter
count, the analytic FLOPs, 6ND and the 45nm training energy for the ten
architectures and the three paper CNNs (rel 1e-12), the roofline terms at
the same device numbers, the ``roofline`` bench's rendering of dry-run
records row for row, the CNN rows' FLOPs and bytes, and ``bench_run --only
roofline``."""
import json

import pytest

torch = pytest.importorskip("torch")

import benchmarks.roofline as jroof  # noqa: E402
from repro.configs import get_experiment as jax_experiment  # noqa: E402
from repro.configs import paper_cnns as jcnns  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_experiment  # noqa: E402
from repro_torch.configs import paper_cnns  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.config import E2TrainConfig as TorchE2  # noqa: E402
from repro_torch.launch import bench_roofline, bench_run  # noqa: E402

REL = 1e-12
CNNS = ("resnet74", "resnet110", "mobilenetv2")


def _pair(name):
    if name in CNNS:
        return getattr(jcnns, name)(), getattr(paper_cnns, name)()
    return jax_experiment(name), get_experiment(name)


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


@pytest.mark.parametrize("name", ARCH_IDS + list(CNNS))
def test_counts_and_flops_equal_the_reference(name):
    jexp, exp = _pair(name)
    assert exp.model.active_param_count() == jexp.model.active_param_count()
    assert exp.model.param_count() == jexp.model.param_count()
    for batch, seq in ((8, 512), (256, 4096)):
        _close(energy.train_step_flops(exp.model, batch, seq),
               jenergy.train_step_flops(jexp.model, batch, seq))
        _close(energy.model_flops_6nd(exp.model, batch, seq),
               jenergy.model_flops_6nd(jexp.model, batch, seq))


@pytest.mark.parametrize("name", ARCH_IDS + list(CNNS))
def test_training_energy_equals_the_reference(name):
    from repro.core.config import E2TrainConfig as JaxE2
    jexp, exp = _pair(name)
    for jt, tt in ((JaxE2(), TorchE2()), (JaxE2.full(), TorchE2.full())):
        for kw in ({}, {"bits_default": 8, "psg_fallback_rate": 0.25}):
            _close(energy.training_energy_pj(exp.model, 4, 256, tt, 10, **kw),
                   jenergy.training_energy_pj(jexp.model, 4, 256, jt, 10,
                                              **kw))


def test_moe_counts_top_k_experts_only():
    m = get_experiment("deepseek_moe_16b").model
    dff = m.moe_d_ff or m.d_ff
    inactive = (m.num_experts - m.top_k) * 3 * m.d_model * dff
    assert m.param_count() - m.active_param_count() == \
        inactive * m.blocks.count("moe")
    dense = get_experiment("qwen2_5_3b").model
    assert dense.active_param_count() == dense.param_count()


@pytest.mark.parametrize("terms", [(1e15, 2e12, 3e9, 1), (5e12, 8e12, 0.0, 4),
                                   (1e9, 1e6, 9e12, 256)])
def test_roofline_terms_equal_the_reference_at_the_same_numbers(terms):
    h = energy.H100_SXM
    jhw = jenergy.HW(name=h.name, peak_flops=h.peak_flops, hbm_bw=h.hbm_bw,
                     ici_bw=h.ici_bw, int8_speedup=h.int8_speedup)
    assert energy.roofline_terms(*terms) == \
        jenergy.roofline_terms(*terms, hw=jhw)


def test_the_card_numbers():
    h = energy.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.int8_speedup) == \
        (989e12, 3.35e12, 450e9, 2.0)
    assert not any("tpu" in k.lower() for k in vars(energy))


def _records():
    """Dry-run records of each status, a 2x16x16 one among them."""
    ok = {"arch": "qwen2_5_3b", "shape": "train_4k", "multi_pod": False,
          "status": "ok", "chips": 256,
          "bytes_per_device": {"argument": 1, "output": 1, "temp": 3,
                               "alias": 1, "peak": 3 * 2**30},
          "model_flops_6nd": 1.94e16, "useful_ratio": 0.625,
          "roofline": energy.roofline_terms(1.2e14, 3.9e12, 1.0e11, 1)}
    coll = dict(ok, shape="decode_32k", multi_pod=True, useful_ratio=0.001,
                roofline=energy.roofline_terms(8e9, 4e11, 9.7e10, 1))
    return [ok, coll,
            {"arch": "llama3_8b", "shape": "long_500k", "multi_pod": False,
             "status": "skipped",
             "reason": "pure full-attention arch: no sub-quadratic 500k "
                       "path (DESIGN.md §5)"},
            {"arch": "xlstm_350m", "shape": "train_4k", "multi_pod": True,
             "status": "error",
             "error": "NotImplementedError: Operator aten.log_sigmoid_"
                      "backward.default does not have a sharding strategy"}]


def test_render_equals_the_reference_row_for_row(tmp_path):
    path = tmp_path / "dryrun_results.json"
    path.write_text(json.dumps(_records()))
    rows = bench_roofline.render(str(path))
    assert rows == jroof.render(str(path))
    assert [r.split(",")[0] for r in rows] == [
        "roofline/qwen2_5_3b/train_4k/16x16",
        "roofline/qwen2_5_3b/decode_32k/2x16x16",
        "roofline/llama3_8b/long_500k/16x16",
        "roofline/xlstm_350m/train_4k/2x16x16"]
    assert "bound=collective" in rows[1]
    missing = bench_roofline.render(str(tmp_path / "absent.json"))
    assert len(missing) == 1 and "repro_torch.launch.dryrun" in missing[0]


def test_cnn_rows_price_the_reference_flops_and_bytes(monkeypatch):
    """The same FLOPs and bytes go into the roofline as in the JAX
    package's rows (priced for another device there)."""
    seen = {"port": [], "jax": []}

    def spy(key, fn):
        def wrapped(flops, nbytes, coll_bytes, chips, **kw):
            seen[key].append((flops, nbytes, coll_bytes, chips))
            return fn(flops, nbytes, coll_bytes, chips, **kw)
        return wrapped
    monkeypatch.setattr(energy, "roofline_terms",
                        spy("port", energy.roofline_terms))
    monkeypatch.setattr(jenergy, "roofline_terms",
                        spy("jax", jenergy.roofline_terms))
    rows = bench_roofline.render_cnn_analytic()
    jrows = jroof.render_cnn_analytic()
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 3
    h = energy.H100_SXM
    for row, jrow, (flops, nbytes, _, _) in zip(rows, jrows, seen["port"]):
        assert row.split(",")[0] == jrow.split(",")[0]
        f = dict(kv.split("=") for kv in row.split(",", 2)[2].split(";"))
        assert float(f["compute_s"]) * h.peak_flops == \
            pytest.approx(flops, rel=5e-3)
        assert float(f["memory_s"]) * h.hbm_bw == \
            pytest.approx(nbytes, rel=5e-3)
        assert f["macs"] == dict(kv.split("=") for kv in jrow.split(
            ",", 2)[2].split(";"))["macs"]


def test_bench_run_roofline_rows(tmp_path, monkeypatch, capsys):
    """``--only roofline`` needs no card: one row a dry-run record, then
    the three CNN rows."""
    (tmp_path / "dryrun_results.json").write_text(json.dumps(_records()))
    monkeypatch.setattr(bench_roofline, "ROOT", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--only", "roofline"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert len(rows) == 1 + len(_records()) + 3
    assert [r.split(",")[0].split("/")[1] for r in rows[-3:]] == list(CNNS)
