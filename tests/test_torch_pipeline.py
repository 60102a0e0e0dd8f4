"""repro_torch's prefetch pipeline (``data/pipeline.py``) and host batch
makers against the JAX package's, on the CPU.

The JAX package's contract (``tests/test_data.py``): SMD drops are decided
before generation (a dropped step is never made), ``close`` joins the
producer also when it is parked in ``put`` or the consumer stopped
mid-stream, and a producer exception is re-raised in the consumer after the
batches made before it.  Against the JAX package: for the same seed and SMD
config both pipelines yield the same ``(step, batch | None)`` stream, the
token batches equal bit for bit and the image batches' labels too; the
images' Gaussian noise is ``rng.normal``'s, within a few ulp of JAX's
(``core/rng.py``), so images are held to 1e-6 absolute (values of a few
units).
"""
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.config import SMDConfig as JSMD  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipeline  # noqa: E402

from repro_torch.core.config import SMDConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402

IMAGE_ATOL = 1e-6


def test_pipeline_prefetch_and_smd():
    task = syn.MarkovLMTask(vocab=32)
    made = []

    def mk(step, shard):
        made.append(step)
        return syn.host_lm_batch(task, 0, step, shard, 2, 8)

    pipe = DataPipeline(mk, SMDConfig(enabled=True, drop_prob=0.5), seed=0)
    out = [next(pipe) for _ in range(40)]
    pipe.close()
    dropped = [s for s, b in out if b is None]
    kept = [s for s, b in out if b is not None]
    assert [s for s, _ in out] == list(range(40))
    assert len(dropped) > 5 and kept
    assert set(made).isdisjoint(dropped)          # a drop is never made


def test_pipeline_close_joins_producer():
    pipe = DataPipeline(lambda step, shard: {"x": torch.full((2,), step)},
                        None, prefetch=1)
    time.sleep(0.3)               # the producer fills the queue and parks
    assert pipe._thread.is_alive()
    assert pipe.close() is True
    assert not pipe._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pipe)


def test_pipeline_close_mid_consumption():
    pipe = DataPipeline(lambda step, shard: {"x": torch.full((4,), step)},
                        None, prefetch=2)
    for _ in range(5):
        next(pipe)
    assert pipe.close() is True
    assert not pipe._thread.is_alive()


def test_pipeline_producer_exception_propagates():
    def mk(step, shard):
        if step >= 3:
            raise RuntimeError("boom at step 3")
        return {"x": torch.full((2,), step)}

    pipe = DataPipeline(mk, None, prefetch=2)
    got = []
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom at step 3"):
        for _ in range(10):
            got.append(next(pipe))
    assert time.monotonic() - t0 < 5.0
    assert [s for s, _ in got] == [0, 1, 2]
    assert pipe.close() is True


def test_pipeline_injected_fault_via_raising_at_step():
    from repro_torch.ft.faults import raising_at_step
    mk = raising_at_step(lambda s, sh: {"x": torch.full((2,), s)}, 2)
    pipe = DataPipeline(mk, None, prefetch=1)
    assert next(pipe)[0] == 0
    assert next(pipe)[0] == 1
    with pytest.raises(RuntimeError):
        next(pipe)
    pipe.close()


def _streams(mine_mk, ref_mk, n, seed=3, drop=0.5, start=5):
    mine = DataPipeline(mine_mk, SMDConfig(enabled=True, drop_prob=drop),
                        seed=seed, start_step=start)
    ref = JPipeline(ref_mk, JSMD(enabled=True, drop_prob=drop), seed=seed,
                    start_step=start)
    try:
        return ([next(mine) for _ in range(n)], [next(ref) for _ in range(n)])
    finally:
        mine.close()
        ref.close()


def test_lm_stream_matches_jax():
    task, jtask = syn.MarkovLMTask(vocab=64), jsyn.MarkovLMTask(vocab=64)
    got, want = _streams(
        lambda s, sh: syn.host_lm_batch(task, 7, s, sh, 3, 12),
        lambda s, sh: jsyn.make_lm_batch(jtask, 7, s, sh, 3, 12), 16)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [b is None for _, b in got] == [b is None for _, b in want]
    assert any(b is None for _, b in got) and any(b is not None
                                                  for _, b in got)
    for (_, b), (_, jb) in zip(got, want):
        if b is None:
            continue
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def test_image_stream_matches_jax():
    task = syn.GaussianImageTask(num_classes=10, snr=2.0)
    jtask = jsyn.GaussianImageTask(num_classes=10, snr=2.0)
    got, want = _streams(
        lambda s, sh: syn.host_image_batch(task, 0, s, sh, 4),
        lambda s, sh: jsyn.make_image_batch(jtask, 0, s, sh, 4), 10)
    assert [(s, b is None) for s, b in got] == \
        [(s, b is None) for s, b in want]
    for (_, b), (_, jb) in zip(got, want):
        if b is None:
            continue
        np.testing.assert_array_equal(b["label"].numpy(),
                                      np.asarray(jb["label"]))
        np.testing.assert_allclose(b["image"].numpy(), np.asarray(jb["image"]),
                                   rtol=0, atol=IMAGE_ATOL)


def test_host_batches_are_the_device_batches():
    img = syn.GaussianImageTask()
    lm = syn.MarkovLMTask(vocab=40)
    pairs = [(syn.host_image_batch(img, 1, 4, 2, 3),
              syn.make_image_batch(img, 1, 4, 2, 3, "cpu")),
             (syn.host_lm_batch(lm, 1, 4, 2, 3, 9),
              syn.make_lm_batch(lm, 1, 4, 2, 3, 9, "cpu"))]
    for host, dev in pairs:
        assert host.keys() == dev.keys()
        for k in host:
            assert host[k].device.type == "cpu"
            assert torch.equal(host[k], dev[k]), k
