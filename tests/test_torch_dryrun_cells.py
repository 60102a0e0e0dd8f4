"""``launch/dryrun.analyze_cell`` on reduced archs (``reduce_experiment``)
at the production meshes, over a world of fake ranks, at cut shape cells
(fewer rows and tokens, the kinds the same, as in ``test_torch_dryrun``):
the cells the dry run must pass are ``ok`` with consistent records on the
``16x16`` mesh; no process group outlives a cell; and 256 devices' FLOPs
cover one rank's whole step as the op counter counts it."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import config as jconfig  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

# the cut shape cells (each kind as the real one), as in test_torch_dryrun
CUT = {"train_4k": dict(kind="train", seq_len=256, global_batch=32),
       "prefill_32k": dict(kind="prefill", seq_len=512, global_batch=32),
       "decode_32k": dict(kind="decode", seq_len=512, global_batch=32)}

MUST_PASS = [("llama3_8b", "train_4k"), ("qwen2_5_3b", "train_4k"),
             ("deepseek_moe_16b", "train_4k"), ("whisper_small", "train_4k"),
             ("zamba2_1_2b", "train_4k"), ("qwen2_5_3b", "prefill_32k"),
             ("qwen2_5_3b", "decode_32k")]


@pytest.fixture
def cut_shapes(monkeypatch):
    for name, cell in CUT.items():
        monkeypatch.setitem(tconfig.SHAPES, name, cell)
        monkeypatch.setitem(jconfig.SHAPES, name, cell)


def _reduced(arch):
    return reduce_experiment(get_experiment(arch))


@pytest.mark.parametrize("arch,shape", MUST_PASS)
def test_required_cells_are_ok(arch, shape, cut_shapes):
    import torch.distributed as dist
    r = dryrun.analyze_cell(arch, shape, False, _reduced(arch))
    assert r["status"] == "ok", r.get("error")
    assert not dist.is_initialized()
    assert r["chips"] == 256 and r["psg_backend"] == "plain"
    b = r["bytes_per_device"]
    assert b["peak"] == b["argument"] + b["temp"] + b["output"] - b["alias"]
    assert b["peak"] >= b["argument"] > 0 and r["hlo_flops_per_device"] > 0
    assert set(r["collectives_body_once"]) == \
        set(dryrun.COLLECTIVES) | {"count", "total"}
    assert r["roofline"]["step_s"] == max(
        r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))


def test_devices_cover_one_rank_of_the_whole_step(cut_shapes):
    """256 devices' counted FLOPs are at least one rank's whole step as
    the op counter counts it (the same reduced step, no mesh, on the
    CPU)."""
    from repro_torch.analysis.op_cost import op_costs
    from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    arch = "qwen2_5_3b"
    r = dryrun.analyze_cell(arch, "train_4k", False, _reduced(arch))
    exp = _reduced(arch).with_shape("train_4k")
    state = init_train_state(exp, device="cpu")
    t = exp.train
    batch = make_lm_batch(MarkovLMTask(vocab=exp.model.vocab_size), 0, 0, 0,
                          t.global_batch, t.seq_len, "cpu")
    step = make_train_step(exp)
    total = op_costs(step, state, batch).total().flops()
    assert r["chips"] * r["hlo_flops_per_device"] >= total > 0
