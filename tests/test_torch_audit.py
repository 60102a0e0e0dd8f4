"""The port's static cost audit (``repro_torch.analysis.audit``, the op
counter ``analysis/op_cost.py`` and the export witness
``launch/export_cost.py``) against the JAX package's
``repro.analysis.audit``, ``repro.tasks.cost_model`` and
``repro.launch.hlo_cost``.

The JAX package's jaxpr walker does not run under this jax (its tests are
red at the seed: ``jax.core.ClosedJaxpr`` is gone), so the audit is held
to the pinned literature count, to the reference's group mapping and
tables, and to the reference's compiled-HLO totals, which still run.
Everything here runs on the CPU at batch 2."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import audit as jaudit  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import paper_cnns as jcnns  # noqa: E402
from repro.configs import smoke_experiment as jsmoke  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.tasks import cost_model as jcost_model  # noqa: E402
from repro_torch import tasks  # noqa: E402
from repro_torch.analysis import audit  # noqa: E402
from repro_torch.analysis.op_cost import op_costs  # noqa: E402
from repro_torch.configs import paper_cnns as tcnns  # noqa: E402
from repro_torch.configs import smoke_experiment  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core.cost import LayerCost, TableCostModel  # noqa: E402
from repro_torch.launch import export_cost  # noqa: E402

# the figure the literature reports as "253 MFLOPs" for CIFAR ResNet-110,
# pinned by the JAX package's tests/test_audit.py too
RESNET110_MACS = 253_149_824
EXPERIMENTS = ["resnet74", "resnet110", "mobilenetv2", "llama3_8b"]


def _pair(name):
    """(the JAX package's experiment, the port's)."""
    if name == "llama3_8b":
        return jsmoke(name), smoke_experiment(name)
    if name == "resnet20":
        return (jc.Experiment(model=jcnns.cnn_model("resnet20", 20),
                              task="cifar_cnn"),
                tc.Experiment(model=tcnns.cnn_model("resnet20", 20),
                              task="cifar_cnn"))
    return getattr(jcnns, name)(), getattr(tcnns, name)()


def test_resnet110_op_macs_match_pinned_exactly():
    """The counted predict program's contraction MACs reproduce the pinned
    literature count exactly, and so does the table."""
    rep = audit.audit_experiment(tcnns.resnet110(), batch=2, with_hlo=False,
                                 device="cpu")
    assert int(round(rep.jaxpr_total_macs)) == RESNET110_MACS
    assert int(round(rep.cost_total_macs)) == RESNET110_MACS


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_groups_and_tables_match_the_reference(name):
    """``_group_of`` maps every layer as the reference's does, and
    ``_table_group_macs`` equals the reference's over its own table."""
    jexp, texp = _pair(name)
    jcost, tcost = jcost_model(jexp), tasks.cost_model(texp)
    names = [l.name for l in tcost.layers]
    assert names == [l.name for l in jcost.layers]
    for layer in names:
        assert audit._group_of(layer, texp.task) == \
            jaudit._group_of(layer, jexp.task), layer
    assert audit._table_group_macs(tcost, texp.task) == \
        jaudit._table_group_macs(jcost, jexp.task)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_rows_within_the_declared_tolerance(name):
    _, exp = _pair(name)
    rep = audit.audit_experiment(exp, batch=2, with_hlo=False, device="cpu")
    assert rep.tolerance == audit.TOL_BY_TASK[exp.task]
    assert rep.passed, rep.summary()
    assert all(r.ok and r.rel_diff <= rep.tolerance for r in rep.rows)
    assert rep.jaxpr_unknown_trips == 0
    groups = {r.group for r in rep.rows}
    if name == "mobilenetv2":
        # the depthwise groups are witnessed by their multiplies alone
        dw = [r for r in rep.rows if r.group.endswith(".dw")]
        assert len(dw) == 17 and all(r.jaxpr_macs > 0 for r in dw)
    elif name == "llama3_8b":
        assert {"embed", "unit", "head"} <= groups
    else:
        assert {"stem", "s0.trans", "s2.rest", "fc"} <= groups


def test_forgotten_table_layer_fails_none_is_not_zero(monkeypatch):
    """A layer the table prices but the program never runs fails the audit
    (None ≠ 0), and so does compute in a group the table forgot."""
    real = tasks.cost_model

    def with_ghost(exp):
        cost = real(exp)
        return TableCostModel(cost.name, cost.layers
                              + (LayerCost("ghost", "fc", 1e6, 0, 0.0),))

    monkeypatch.setattr(tasks, "cost_model", with_ghost)
    rep = audit.audit_experiment(tcnns.resnet74(), batch=2, with_hlo=False,
                                 device="cpu")
    assert not rep.passed
    (row,) = [r for r in rep.rows if r.group == "ghost"]
    assert row.cost_macs == 1e6 and row.jaxpr_macs is None and not row.ok
    monkeypatch.setattr(tasks, "cost_model", real)

    cost = real(tcnns.resnet74())
    no_fc = TableCostModel(cost.name, tuple(l for l in cost.layers
                                            if l.name != "fc"))
    rep = audit.audit_experiment(tcnns.resnet74(), batch=2, with_hlo=False,
                                 device="cpu", cost=no_fc)
    (row,) = [r for r in rep.rows if r.group == "fc"]
    assert row.cost_macs is None and row.jaxpr_macs == 640 and not rep.passed


def _jax_hlo_flops(jexp, batch):
    predict, params, mstate, data = jaudit._abstract_inputs(jexp, batch)
    text = jax.jit(predict).lower(params, mstate, data).compile().as_text()
    return hlo_cost.analyze(text)


@pytest.mark.parametrize("name", ["resnet20", "llama3_8b"])
def test_export_totals_reconcile_with_the_references_compiled_hlo(name):
    """The lowered program's FLOPs (``hlo_cost``'s rules over the graph
    ``torch.export`` lowers the port's predict program to) are within
    ``HLO_TOL`` of the reference's compiled-HLO totals at the same batch,
    and of the port's own op counter; no loop has an unknown trip."""
    jexp, texp = _pair(name)
    want = _jax_hlo_flops(jexp, 2)
    assert want["unknown_trip_count"] == 0
    fn, model, x = audit.predict_program(texp, 2, torch.device("cpu"))
    got = export_cost.analyze(fn, (model,), (x,))
    assert got["unknown_trip_count"] == 0
    rel = abs(got["flops"] - want["flops"]) / max(got["flops"], want["flops"])
    assert rel <= audit.HLO_TOL, (got, want)
    ops = op_costs(fn, model, x).total().flops()
    assert abs(got["flops"] - ops) / max(got["flops"], ops) <= audit.HLO_TOL


def test_audit_passes_with_the_lowered_column_on_the_smoke_lm():
    rep = audit.audit_experiment(smoke_experiment("llama3_8b"), batch=2,
                                 device="cpu")
    assert rep.hlo_total_flops is not None and rep.hlo_unknown_trips == 0
    assert rep.hlo_rel_diff <= rep.hlo_tolerance
    assert rep.passed, rep.failures()


def test_record_keys_match_the_references():
    rep = audit.audit_experiment(tcnns.resnet74(), batch=2, with_hlo=False,
                                 device="cpu")
    d = rep.to_dict()
    assert list(d) == [f.name for f in
                       dataclasses.fields(jaudit.AuditReport)]
    assert list(d["rows"][0]) == [f.name for f in
                                  dataclasses.fields(jaudit.LayerRow)]
    assert d["passed"] is True and dataclasses.asdict(rep)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_experiment_matches_the_references(arch):
    """``smoke_experiment(arch)`` equals the reference's field by field
    (the reference's training config also names its loss, which the port
    fixes: cross-entropy, no smoothing)."""
    j, t = jsmoke(arch), smoke_experiment(arch)
    assert j.task == t.task
    for part in ("model", "train", "serve", "e2"):
        jd = dataclasses.asdict(getattr(j, part))
        td = dataclasses.asdict(getattr(t, part))
        assert {k: jd[k] for k in td} == td, part
        assert {k: jd[k] for k in set(jd) - set(td)} in (
            {}, {"loss": "xent", "label_smoothing": 0.0}), part


def test_op_counter_refuses_a_program_that_reaches_the_kernels():
    """A counted program may not reach the kernel dispatch layer: a kernel
    launch is invisible to it and would count as 0."""
    from repro_torch.core import psg
    from repro_torch.models.resnet import ResNet

    model = ResNet(8, width=4)
    x = torch.from_numpy(np.zeros((2, 32, 32, 3), np.float32))
    with psg.enable(tc.PSGConfig(enabled=True)):
        with pytest.raises(RuntimeError, match="dispatch layer"):
            op_costs(model, x)
