"""The port's data loader (``repro_torch.data.loader``): ``Prefetcher``
keeps the source's order, re-raises its error after the batches before
it, and stops on ``close``; ``FailingIterator`` raises at its batch;
``to_device`` places a tree of host arrays as tensors (exactly: a copy)."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import FailingIterator, PhantomConfig, Prefetcher, phantom_batches, to_device  # noqa: E402


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_keeps_order(depth):
    got = list(Prefetcher(iter(range(20)), depth=depth, transform=lambda x: 2 * x))
    assert got == [2 * i for i in range(20)]


def test_prefetcher_propagates_the_source_error_after_its_batches():
    pf = Prefetcher(FailingIterator(iter(range(10)), fail_at=3))
    assert [next(pf) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="injected data failure at batch 3"):
        next(pf)


def test_prefetcher_close_stops_the_producer():
    produced = []

    def slow():
        for i in range(1000):
            produced.append(i)
            yield i

    pf = Prefetcher(slow(), depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(produced) < 10  # stopped well before the end of the source


def test_prefetcher_runs_ahead_by_depth():
    """The producer fills ``depth`` batches ahead of the consumer, and no
    more (it blocks on the full queue)."""
    pf = Prefetcher(iter(range(100)), depth=3)
    deadline = time.monotonic() + 10
    while pf.q.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert pf.q.qsize() == 3
    assert next(pf) == 0
    pf.close()


def test_failing_iterator():
    it = FailingIterator(iter("abcd"), fail_at=2)
    assert next(it) == "a" and next(it) == "b"
    with pytest.raises(RuntimeError, match="batch 2"):
        next(it)
    assert list(FailingIterator(iter("ab"), fail_at=5)) == ["a", "b"]


def test_to_device_places_a_batch_tree():
    batch = next(phantom_batches(2, PhantomConfig(img_size=16), seed=0))
    out = to_device(batch, "cpu")
    assert set(out) == set(batch)
    for k in batch:
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(batch[k]))
    nested = to_device({"a": [np.ones(3, np.float32), torch.zeros(2)]}, torch.device("cpu"))
    assert nested["a"][0].dtype == torch.float32 and torch.equal(nested["a"][1], torch.zeros(2))


@pytest.mark.cuda
def test_to_device_on_the_card_is_exact():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch = {"x": np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)}
    pf = Prefetcher(iter([batch] * 3), transform=lambda b: to_device(b, "cuda"))
    for got in pf:
        assert got["x"].device.type == "cuda"
        np.testing.assert_array_equal(got["x"].cpu().numpy(), batch["x"])
