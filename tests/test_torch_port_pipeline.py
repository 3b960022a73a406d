"""The port's data loader and per-item draws against the JAX package's.

The cases of ``tests/test_pipeline.py``, parametrised over datasets,
seeds and cursors: the port's ``DataLoader`` yields the JAX loader's
batches (no device, identity ``post_fn``), a loader built from a
mid-epoch cursor replays the rest, augmentation is keyed on the epoch,
and ``close()`` reaps a producer blocked on a full queue.  With a CPU
``device`` the batches are tensors of the same values.
"""

import time

import numpy as np
import pytest
import torch

from upflow_pytorch_tpu.data import pipeline as jpipe
from upflow_pytorch_tpu.data.rng import item_rng as jax_item_rng

from upflow_pytorch_tpu_torch.data import pipeline as ppipe
from upflow_pytorch_tpu_torch.data.rng import item_rng

N_ITEMS, BATCH = 10, 2
EPOCH_BATCHES = N_ITEMS // BATCH


class ToyDataset:
    def __len__(self):
        return N_ITEMS

    def __getitem__(self, i):
        return {"x": np.full((2, 2), float(i), np.float32),
                "n": np.array([i], np.int64)}


class AugDataset:
    """Stateless per-item augmentation keyed on (seed, epoch, index), the
    contract of the KITTI and Sintel train sets."""

    def __init__(self, seed=0):
        self.seed = seed

    def __len__(self):
        return N_ITEMS

    def item(self, i, epoch=0):
        rng = item_rng(self.seed, epoch, i)
        return {"x": np.full((2, 2), i + rng.random(), np.float32)}


DATASETS = {"toy": ToyDataset, "aug": AugDataset}


def take(loader, n, key="x"):
    it = iter(loader)
    out = [np.asarray(next(it)[key]) for _ in range(n)]
    loader.close()
    return out


def port_loader(dataset, seed, **kw):
    kw.setdefault("num_workers", 2)
    return ppipe.DataLoader(DATASETS[dataset](), BATCH, seed=seed,
                            post_fn=lambda b: b, **kw)


@pytest.mark.parametrize("seed", [0, 3, 9])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_batches_match_jax_over_three_epochs(dataset, seed):
    n = 3 * EPOCH_BATCHES
    want = take(jpipe.DataLoader(DATASETS[dataset](), BATCH, seed=seed,
                                 num_workers=2, device=None,
                                 post_fn=lambda b: b), n)
    got = take(port_loader(dataset, seed), n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # every item once an epoch, in another order each epoch
    epochs = [np.concatenate(got[e * EPOCH_BATCHES:(e + 1) * EPOCH_BATCHES])
              for e in range(3)]
    for e in epochs:
        assert sorted(e[:, 0, 0].astype(int)) == list(range(N_ITEMS))
    assert not np.array_equal(epochs[0], epochs[1])


@pytest.mark.parametrize("seed,epoch,index",
                         [(0, 0, 0), (5, 2, 7), (123, 40, 9999)])
def test_item_rng_draws_match_jax(seed, epoch, index):
    a = item_rng(seed, epoch, index)
    b = jax_item_rng(seed, epoch, index)
    assert np.array_equal(a.random(8), b.random(8))
    assert np.array_equal(a.integers(0, 1000, 8), b.integers(0, 1000, 8))


@pytest.mark.parametrize("consumed", [2, 3, 6])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_resume_from_consumed_cursor(dataset, consumed):
    """``state()`` is the consumed cursor, not the producer's (which runs
    up to prefetch + 1 batches ahead): a loader built from it replays the
    remaining batches, augmentation draws included."""
    full = take(port_loader(dataset, 7), consumed + 5)
    first = port_loader(dataset, 7, prefetch=1)
    it = iter(first)
    for _ in range(consumed):
        next(it)
    time.sleep(0.2)  # let the producer race ahead into the queue
    st = first.state()
    first.close()
    assert (st["epoch"], st["position"]) == divmod(consumed, EPOCH_BATCHES)
    rest = take(port_loader(dataset, 7, epoch=st["epoch"],
                            position=st["position"]), 5)
    for a, b in zip(rest, full[consumed:]):
        assert np.array_equal(a, b)
    resumed = port_loader(dataset, 7)
    resumed.set_cursor(st["epoch"], st["position"])
    for a, b in zip(take(resumed, 5), full[consumed:]):
        assert np.array_equal(a, b)


def test_set_cursor_after_iterating_raises():
    loader = port_loader("toy", 0)
    next(iter(loader))
    with pytest.raises(RuntimeError):
        loader.set_cursor(0, 0)
    loader.close()


def test_augmentation_differs_across_epochs():
    batches = take(port_loader("aug", 4), 2 * EPOCH_BATCHES)
    e0 = sorted(x for b in batches[:EPOCH_BATCHES] for x in b[:, 0, 0])
    e1 = sorted(x for b in batches[EPOCH_BATCHES:] for x in b[:, 0, 0])
    assert [int(v) for v in e0] == [int(v) for v in e1]
    assert e0 != e1


def test_close_with_blocked_producer_terminates():
    loader = ppipe.DataLoader(ToyDataset(), 1, seed=0, num_workers=1,
                              post_fn=lambda b: b, prefetch=1)
    next(iter(loader))
    time.sleep(0.2)  # the producer fills the queue and blocks in put
    loader.close()
    assert loader._thread is not None and not loader._thread.is_alive()


def test_cpu_device_gives_tensors():
    want = take(port_loader("toy", 2), 3, key="n")
    loader = ppipe.DataLoader(ToyDataset(), BATCH, seed=2, num_workers=2,
                              device="cpu")
    it = iter(loader)
    for w in want:
        batch = next(it)
        assert isinstance(batch["n"], torch.Tensor)
        assert batch["x"].dtype == torch.float32
        assert np.array_equal(batch["n"].numpy(), w)
    loader.close()


def test_dataset_error_reaches_the_consumer():
    class Broken(ToyDataset):
        def __getitem__(self, i):
            raise IndexError("item %d" % i)

    loader = ppipe.DataLoader(Broken(), BATCH, num_workers=1,
                              post_fn=lambda b: b)
    with pytest.raises(IndexError):
        next(iter(loader))
    loader.close()
