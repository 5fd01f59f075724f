"""Multiprocess prefetching batch loader (numpy only).

The port's copy of ``coponerf_tpu/data/loader.py``.  The reference feeds
training through a torch DataLoader with 8 workers and a reseeding
worker_init_fn (train.py:62-64,89-90); here worker processes run the
dataset's __getitem__ + collate off the consuming thread and a bounded
ready-queue keeps batches ahead of the device.

Design notes:
  - ``spawn`` start method: the parent holds a CUDA context, which must not
    be inherited through fork; workers touch no device (the datasets are
    numpy/cv2 only).
  - Each worker reseeds numpy per (epoch, worker) — the reference's
    worker_init_fn parity (train.py:62-64).
  - Batches come in task order: with ``rank``/``world`` (data-parallel
    training) every rank walks the same shuffled order of global batches
    and decodes only its rows of each, so one step's shares make up one
    global batch.
  - As with any ``spawn``-based multiprocessing (torch DataLoader included),
    the entry script must guard its body with ``if __name__ == "__main__":``
    or workers re-execute it on import.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
from typing import Iterator, Optional

import numpy as np

from coponerf_tpu_torch.data.scene_dataset import collate


def _worker(dataset, task_q, result_q, base_seed: int):
    while True:
        task = task_q.get()
        if task is None:
            return
        epoch, task_id, idxs = task
        np.random.seed((base_seed + 1000003 * epoch + task_id) % (2**31))
        try:
            items = [dataset[int(i)] for i in idxs]
            result_q.put((task_id, collate(items), None))
        except Exception as e:  # surface worker failures to the main loop
            result_q.put((task_id, None, repr(e)))


class PrefetchLoader:
    """Iterates collated batches produced by ``num_workers`` processes.

    shuffle=True: endless stream over reshuffled epochs (training), in
    task order.
    shuffle=False: exactly one in-order epoch (eval).  With num_workers > 0
    the decode runs in worker processes and results are reassembled in task
    order (a bounded reorder buffer), so eval stays deterministic for
    deterministic-per-index datasets (VisSceneDataset et al.) while scene
    decode overlaps the consumer's device work — the reference's
    DataLoader-at-eval equivalent (test.py:130).

    ``batch_size`` is the global batch; with ``world`` > 1 each batch holds
    this ``rank``'s rows of it (``batch_size // world``, rows ``rank *
    batch_size // world`` onward), the shuffled order being the same on
    every rank.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self._procs = []
        self._task_q = None
        self._result_q = None

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_batches(self, rng, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        stop = len(order) - (self.batch_size - 1 if self.drop_last else 0)
        per = self.batch_size // self.world
        lo = self.rank * per
        return [order[s: s + self.batch_size][lo: lo + per] for s in range(0, stop, self.batch_size)]

    def _tasks(self) -> Iterator:
        """(epoch, row indices) of each batch in order: one epoch, or with
        ``shuffle`` reshuffled epochs without end."""
        rng = np.random.RandomState(self.seed)
        epoch = 0
        while True:
            for idxs in self._epoch_batches(rng, epoch):
                yield epoch, idxs
            if not self.shuffle:
                return
            epoch += 1

    def _serial_iter(self) -> Iterator:
        for _, idxs in self._tasks():
            yield collate([self.dataset[int(i)] for i in idxs])

    def _start(self):
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue(maxsize=self.num_workers + self.prefetch)
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker,
                args=(self.dataset, self._task_q, self._result_q, self.seed + 7919 * w + 104729 * self.rank),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def close(self):
        for _ in self._procs:
            try:
                self._task_q.put_nowait(None)
            except queue_mod.Full:
                pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
        self._procs = []

    def _worker_iter(self) -> Iterator:
        """Worker-decoded batches, yielded strictly in task order, at most
        ``num_workers + prefetch`` tasks ahead of the consumer (a bounded
        reorder buffer)."""
        self._start()
        tasks = self._tasks()
        buf = {}
        submitted = next_yield = 0
        try:
            while True:
                while submitted - next_yield < self.num_workers + self.prefetch:
                    task = next(tasks, None)
                    if task is None:
                        break
                    self._task_q.put((task[0], submitted, task[1]))
                    submitted += 1
                if next_yield == submitted:
                    return
                while next_yield not in buf:
                    tid, batch, err = self._result_q.get()
                    if err is not None:
                        raise RuntimeError(f"loader worker failed on task {tid}: {err}")
                    buf[tid] = batch
                yield buf.pop(next_yield)
                next_yield += 1
        finally:
            self.close()

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            yield from self._serial_iter()
            return
        if self._procs:
            # a previous iteration was abandoned mid-stream: its workers and
            # undrained result queue would leak stale batches (wrong
            # epoch/shuffle mix) into this iteration — restart the pool with
            # fresh queues instead
            self.close()
        if self.shuffle and len(self) == 0:
            raise ValueError(
                f"no batches: dataset of {len(self.dataset)} items with "
                f"batch_size={self.batch_size} and drop_last={self.drop_last}"
            )
        yield from self._worker_iter()


def make_loader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: Optional[int] = 8,
    prefetch: int = 4,
    rank: int = 0,
    world: int = 1,
) -> Iterator:
    """An iterator over ``PrefetchLoader``'s batches (this ``rank``'s rows
    of each global batch of ``batch_size``)."""
    loader = PrefetchLoader(
        dataset, batch_size, shuffle=shuffle, seed=seed,
        num_workers=num_workers or 0, prefetch=prefetch, rank=rank, world=world,
    )
    return iter(loader)
