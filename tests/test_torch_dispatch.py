"""The kernel dispatch layer of repro_torch (``kernels/dispatch.py``).

Backend selection (override, then ``PSGConfig.backend``, then the
``REPRO_TORCH_KERNEL_BACKEND`` pin read once at import, then ``auto`` by the
tensors' device), the names it refuses, and the reference backend against
the JAX package's: the element-level signs and fallback ratio of
``psg_grad_w`` over ``tests/test_dispatch.py``'s shapes (bit for bit), and a
whole ResNet train step with both packages pinned to ``reference``
(tolerances of ``tests/test_torch_train.py``, for its reasons).
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_cnns import cnn_model as jcnn_model  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core.config import PSGConfig  # noqa: E402
from repro_torch.core.quant import qscale  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import TrainState, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = PSGConfig(enabled=True)
JCFG = jc.PSGConfig(enabled=True)
SHAPES = [(64, 32, 48), (300, 130, 70), (512, 256, 128), (1024, 256, 256),
          (128, 7, 9)]


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def test_order_of_precedence():
    pinned = PSGConfig(enabled=True, backend="reference")
    assert dispatch.default_backend() == "auto"      # no env pin in tests
    assert dispatch.resolve_backend(CFG) == "auto"
    assert dispatch.resolve_backend(pinned) == "reference"
    try:
        dispatch.set_default_backend("plain")
        assert dispatch.resolve_backend(CFG) == "plain"
        assert dispatch.resolve_backend(pinned) == "reference"
        with dispatch.override_backend("cuda"):
            assert dispatch.resolve_backend(pinned) == "cuda"
            assert dispatch.resolve_backend(None) == "cuda"
        assert dispatch.resolve_backend(pinned) == "reference"
    finally:
        dispatch.set_default_backend(None)
    assert dispatch.resolve_backend(CFG) == "auto"


def test_auto_follows_the_device():
    # auto is left to the wrappers, which take the plain version on CPU
    x = torch.randn(7, 300, generator=torch.Generator().manual_seed(0))
    assert dispatch.backend_for(CFG, x) == "auto"
    with dispatch.override_backend("reference"):
        assert dispatch.backend_for(CFG, x) == "reference"
    Q.reset_launches()
    got = dispatch.quantize(x, 8, CFG)
    assert Q.LAUNCHES["quantize"] == 0
    torch.testing.assert_close(got, Q.quantize_plain(x, qscale(x, 8), 8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("env,want", [("reference", "reference"),
                                      ("PLAIN", "plain"), ("", "auto")])
def test_env_pin_is_read_once_at_import(env, want):
    code = ("import os; from repro_torch.kernels import dispatch; "
            "os.environ['REPRO_TORCH_KERNEL_BACKEND'] = 'cuda'; "
            "print(dispatch.default_backend())")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
             "REPRO_TORCH_KERNEL_BACKEND": env, "REPRO_KERNEL_BACKEND":
             "reference"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == want


def test_invalid_env_pin_fails_naming_the_backends():
    proc = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import dispatch; "
         "dispatch.default_backend()"], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
             "REPRO_TORCH_KERNEL_BACKEND": "triton"})
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "'reference'" in proc.stderr


@pytest.mark.parametrize("name,hint", [("interpret", "'plain'"),
                                       ("mosaic", "'cuda'"), ("nope", None)])
def test_unknown_and_jax_names_raise(name, hint):
    for make in (lambda: PSGConfig(enabled=True, backend=name),
                 lambda: dispatch.override_backend(name).__enter__(),
                 lambda: dispatch.set_default_backend(name)):
        with pytest.raises(ValueError, match="expected one of") as e:
            make()
        if hint:
            assert hint in str(e.value)
    assert dispatch.default_backend() == "auto"


def test_cuda_pin_on_cpu_tensors_raises():
    x, w = torch.randn(2, 6, 6, 3), torch.randn(27, 4)
    gy = torch.randn(2, 4, 4, 4)
    q = torch.randn(1, 8, 2, 16)
    calls = [lambda: dispatch.quantize(x, 8),
             lambda: dispatch.psg_grad_w(torch.randn(8, 3), torch.randn(8, 2),
                                         CFG),
             lambda: dispatch.conv_fwd(x, w, CFG, k=3, stride=1),
             lambda: dispatch.conv_grad_x(gy, w, CFG, k=3, stride=1, hp=6,
                                          wp=6),
             lambda: dispatch.conv_grad_w(x, gy, CFG, k=3, stride=1),
             lambda: dispatch.attention_fwd(q, q, q, CFG)]
    for call in calls:
        with dispatch.override_backend("cuda"), \
                pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.quantize(x, 8, PSGConfig(enabled=True, backend="cuda"))


def test_plain_and_auto_run_the_tile_level_ops_on_the_cpu():
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(300, 130).astype(np.float32))
    gy = torch.from_numpy((r.randn(300, 70) * 0.01).astype(np.float32))
    want = ops.psg_grad_w(x, gy, CFG)
    for backend in ("auto", "plain"):
        with dispatch.override_backend(backend):
            got = dispatch.psg_grad_w(x, gy, CFG)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the reference backend against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,din,dout", SHAPES)
def test_reference_signs_and_element_ratio_equal_jax(N, din, dout):
    r = np.random.RandomState(N + din)
    x = (r.randn(N, din) * 0.5).astype(np.float32)
    gy = (r.randn(N, dout) * 0.01).astype(np.float32)
    with dispatch.override_backend("reference"):
        sign, fb = dispatch.psg_grad_w(torch.from_numpy(x),
                                       torch.from_numpy(gy), CFG)
    jx, jg = jnp.asarray(x), jnp.asarray(gy)
    np.testing.assert_array_equal(sign.numpy(),
                                  np.asarray(jref.psg_grad_w_ref(jx, jg,
                                                                 JCFG)))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(
        jref.psg_fallback_ratio_ref(jx, jg, JCFG)))
    # the tile-level signs are the same; the tile ratio is another measure
    tile_sign, tile_fb = dispatch.psg_grad_w(torch.from_numpy(x),
                                             torch.from_numpy(gy), CFG)
    torch.testing.assert_close(tile_sign, sign, rtol=0, atol=0)
    assert float(tile_fb) >= float(fb)


def test_backward_keeps_the_backend_of_its_forward():
    r = np.random.RandomState(1)
    x = torch.from_numpy((r.randn(512, 96) * 0.5).astype(np.float32))
    gy = torch.from_numpy((r.randn(512, 40) * 0.01).astype(np.float32))
    w = torch.randn(96, 40, requires_grad=True)
    probe = tpsg.zero_probe()
    with dispatch.override_backend("reference"), tpsg.enable(CFG, probe):
        y = tpsg.matmul(x, w)
    (y * gy).sum().backward()          # outside the override
    with dispatch.override_backend("reference"):
        sign, fb = dispatch.psg_grad_w(x, gy, CFG)
    torch.testing.assert_close(w.grad, sign, rtol=0, atol=0)
    torch.testing.assert_close(tpsg.probe_fallback_ratio(probe.grad), fb)


DEPTH, WIDTH, BATCH = 8, 8, 2
TOL = dict(rtol=1e-2, atol=1e-2)


def test_train_step_pinned_to_reference_matches_jax():
    kw = dict(global_batch=BATCH, lr=0.03, optimizer="psg", total_steps=4)
    jexp = jc.Experiment(
        model=jcnn_model(f"resnet{DEPTH}", DEPTH, width=WIDTH),
        e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True),
                            psg=jc.PSGConfig(enabled=True, fused_conv=True,
                                             backend="reference",
                                             swa_start_frac=0.0)),
        train=jc.TrainConfig(**kw), task="cifar_cnn")
    texp = tc.Experiment(
        model=cnn_model(f"resnet{DEPTH}", DEPTH, width=WIDTH),
        e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                            psg=tc.PSGConfig(enabled=True,
                                             backend="reference",
                                             swa_start_frac=0.0)),
        train=tc.TrainConfig(**kw), task="cifar_cnn")
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    model = ResNet(DEPTH, 10, texp.e2, width=WIDTH)
    np_ = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    model.load_state_dict(state_dict_from_jax(np_(jstate.params),
                                              np_(jstate.model_state)))
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 0)
    r = np.random.RandomState(1)
    batch = {"image": r.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 10, (BATCH,)).astype(np.int32)}
    rng = jax.random.fold_in(jax.random.PRNGKey(jexp.train.seed), 0)
    with jpsg.enable(jexp.e2.psg):
        _, aux, _ = JR.resnet_fwd(jstate.params, jstate.model_state,
                                  jnp.asarray(batch["image"]), DEPTH, jexp.e2,
                                  rng)
    keep = [bool(e) for e in np.asarray(aux["slu_executed"])]

    jnew, jmet = jmake(jexp)(jstate, jax.tree.map(jnp.asarray, batch))
    new, met = make_train_step(texp)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, keep=keep)
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio",
              "psg_fallback_ratio"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    # element-level: a fraction of entries, well below the tile ratio of 1
    assert 0.0 < float(met["psg_fallback_ratio"]) < 1.0
    want = state_dict_from_jax(np_(jnew.params), np_(jnew.model_state))
    for name, p in new.model.named_parameters():
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())
