"""Batch loader with background prefetch (the port's copy of the JAX
package's data/loader.py).

Replaces the reference's torch DataLoader workers (src/main.py:141-148).
Two modes:
  * num_workers=0 — a double-buffered prefetch thread: sample encoding
    (numpy ops that release the GIL) overlaps device compute;
  * num_workers>0 — a pool of worker processes encodes samples in
    parallel (the reference's multi-worker DataLoader equivalent), with
    batches reassembled in submission order.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


def stack_batch(samples) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        if key == "meta":
            out[key] = [s[key] for s in samples]
        else:
            out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out


_WORKER_SAMPLER = None


def _worker_init(sampler, epoch_seed):
    """Install the sampler in a worker and give it a unique RNG stream.

    Reseeds per (epoch, worker) so that (a) workers do not replay each
    other's augmentation stream and (b) a fresh pool each epoch does not
    replay the previous epoch's stream (the parent's sampler RNG never
    advances — only workers consume it).
    """
    global _WORKER_SAMPLER
    _WORKER_SAMPLER = sampler
    import multiprocessing as mp

    ident = mp.current_process()._identity
    wid = ident[0] if ident else 0
    if hasattr(sampler, "rng"):
        sampler.rng = np.random.RandomState(
            (int(epoch_seed) * 1000003 + wid) % (2 ** 32))


def _worker_encode(batch_idx):
    return stack_batch([_WORKER_SAMPLER(int(i)) for i in batch_idx])


class Loader:
    """Iterate shuffled fixed-size batches from a sampler."""

    def __init__(self, sampler: Callable[[int], dict], num_samples: int,
                 batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2, seed: int = 0, num_workers: int = 0,
                 rank: int = 0, world: int = 1):
        """rank/world shard the sample index space over data-parallel
        ranks, as the JAX package's Loader does: every rank shuffles the
        whole index space with the same seed and keeps
        indices[rank::world][:N // world], so the shards are disjoint and
        every rank runs the same number of batches (a collective step
        would wait forever otherwise); the N % world left over rotate in
        through the next epoch's shuffle, or, unshuffled (val), through a
        roll of the index space by epoch * (N % world)."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of world {world}")
        self.sampler = sampler
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.rank = rank
        self.world = world
        self.rng = np.random.RandomState(seed)
        self._epoch = 0
        # indices of the last pass that no rank's shard held
        self.left_out = np.zeros(0, np.int64)

    @property
    def _num_local(self):
        if self.world == 1:
            return self.num_samples
        return self.num_samples // self.world

    def __len__(self):
        if self.drop_last:
            return self._num_local // self.batch_size
        return (self._num_local + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(self.num_samples)
        if self.shuffle:
            # the same seed on every rank: one permutation, split by stride
            self.rng.shuffle(idx)
        elif self.world > 1:
            idx = np.roll(idx, -self._epoch * (self.num_samples % self.world))
        self._epoch += 1
        if self.world > 1:
            self.left_out = idx[self._num_local * self.world:]
            idx = idx[self.rank::self.world][:self._num_local]
        n = len(self) * self.batch_size if self.drop_last else len(idx)
        for i in range(0, n, self.batch_size):
            yield idx[i:i + self.batch_size]

    def _iter_threaded(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            # a sampler exception must reach the consumer, not die on
            # the thread excepthook — otherwise the epoch silently
            # truncates and training continues on partial data (torch's
            # DataLoader likewise propagates worker exceptions)
            try:
                for batch_idx in self._index_batches():
                    samples = [self.sampler(int(i)) for i in batch_idx]
                    q.put(stack_batch(samples))
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def _iter_processes(self) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp

        # spawn, not fork: by the time training iterates the parent has a
        # live, multithreaded CUDA runtime, and forking a threaded process
        # can deadlock; the sampler reaches the workers pickled
        ctx = mp.get_context("spawn")
        # the shared draw first (it keeps the ranks' permutations in step),
        # then each rank's own augmentation stream
        epoch_seed = (int(self.rng.randint(0, 2 ** 31 - 1))
                      + self.rank * 7919)
        with ctx.Pool(self.num_workers, initializer=_worker_init,
                      initargs=(self.sampler, epoch_seed)) as pool:
            # imap keeps submission order; workers run ahead by the
            # pool's chunking and the iterator's laziness
            yield from pool.imap(_worker_encode, self._index_batches())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers > 0:
            return self._iter_processes()
        return self._iter_threaded()
