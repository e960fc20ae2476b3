"""A copy of `uninext_tpu/data/loader.py` (the port imports nothing of the
JAX package): image batches and, from a video mapper, (key, ref) pair
batches (`data/video.py:collate_video`).

Multi-dataset weighted loader with static-shape bucketing.

Parity anchors (reference data/custom_dataset_dataloader.py):
  * MultiDatasetSampler            — :195-265 (weighted multinomial over
    datasets via DATASET_RATIO, rank-strided infinite stream)
  * DIFFMDAspectRatioGroupedDataset— :288 (grouped batching by (dataset,
    aspect), per-dataset batch sizes)

Grouping is by (dataset, padded bucket shape), so every emitted batch has
one shape; the sampler is an infinite generator sharded per process
(`process_index`).
Workers: a thread pool keeps the host pipeline ahead of the device.
"""
from __future__ import annotations

import bisect
import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .coco import MappedSample
from .video import collate_video


def collate(samples: Sequence[MappedSample]) -> Dict[str, np.ndarray]:
    """Stack same-bucket samples into one batch dict (model contract)."""
    batch = {
        "images": np.stack([s.image for s in samples]),
        "img_mask": np.stack([s.img_mask for s in samples]),
        "image_sizes": np.stack([s.image_size for s in samples]),
        "text_ids": np.stack([s.text_ids for s in samples]),
        "text_mask": np.stack([s.text_mask for s in samples]),
        "targets": {
            "boxes": np.stack([s.boxes for s in samples]),
            "valid": np.stack([s.valid for s in samples]),
            "positive_map": np.stack([s.positive_map for s in samples]),
        },
    }
    if samples[0].masks is not None:
        # NOTE: has_masks stays OUT of the pytree (it is a static argument of
        # make_train_step); presence of the "masks" key is the host-side signal
        batch["targets"]["masks"] = np.stack([s.masks for s in samples])
    if samples[0].box_bitmasks is not None:
        batch["targets"]["box_bitmasks"] = np.stack([s.box_bitmasks for s in samples])
        batch["targets"]["color_similarity"] = np.stack(
            [s.color_similarity for s in samples])
    return batch


def _record_categories(record) -> set:
    """Category ids present in an image or video record."""
    if "tracks" in record:
        return {t.get("category_id", 0) for t in record["tracks"]}
    return {a.get("category_id", 0)
            for a in record.get("annotations", [])}


def repeat_factors_from_category_frequency(records: Sequence[Dict],
                                           repeat_thresh: float = 0.001
                                           ) -> np.ndarray:
    """LVIS-style repeat factors (DATALOADER.USE_RFS — reference
    MultiDatasetSampler, custom_dataset_dataloader.py:228-246, which calls
    d2 RepeatFactorTrainingSampler.repeat_factors_from_category_frequency):
    r(I) = max_{c in I} max(1, sqrt(t / f(c))), normalized to preserve the
    dataset's total sampling mass."""
    n = len(records)
    freq: Dict[int, int] = {}
    for r in records:
        for c in _record_categories(r):
            freq[c] = freq.get(c, 0) + 1
    cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (f / n)))
               for c, f in freq.items()}
    w = np.array([max([cat_rep[c] for c in _record_categories(r)] or [1.0])
                  for r in records], np.float64)
    return w * (n / w.sum())


def class_aware_weights(records: Sequence[Dict]) -> np.ndarray:
    """ClassAwareSampler distribution (reference data/build.py:265, the
    obj365 pretrain sampler): pick a category uniformly, then a record
    containing it — P(I) = (1/C) * sum_{c in I} 1/N_c as per-record
    weights."""
    counts: Dict[int, int] = {}
    for r in records:
        for c in _record_categories(r):
            counts[c] = counts.get(c, 0) + 1
    w = np.array([sum(1.0 / counts[c] for c in _record_categories(r))
                  for r in records], np.float64)
    w[w == 0] = w[w > 0].min() if (w > 0).any() else 1.0
    return w / w.sum()


class MultiDatasetLoader:
    """Infinite stream of collated batches.

    datasets: list of (records, mapper, batch_size[, task]); ratios:
    sampling weights. With the optional 4th element, emitted batches carry
    a host-side "__task__" key so a joint-stage trainer can route each batch
    to the matching train step (detection / grounding / sot) — the
    reference's dataset_source dispatch (uninext_vid.py:256-300).
    record_weights: optional per-dataset per-record sampling weights
    (None entry = uniform epoch shuffling); build with
    `repeat_factors_from_category_frequency` (USE_RFS) or
    `class_aware_weights` (obj365 ClassAwareSampler).
    """

    def __init__(self, datasets: List[tuple], ratios: Sequence[float],
                 seed: int = 0, num_workers: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 buckets_per_group: int = 32,
                 record_weights: Optional[Sequence[
                     Optional[np.ndarray]]] = None):
        self.datasets = datasets
        self.ratios = np.asarray(ratios, np.float64)
        self.ratios /= self.ratios.sum()
        self.seed = seed
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.record_weights = (list(record_weights) if record_weights
                               else [None] * len(datasets))
        for d, w in enumerate(self.record_weights):
            if w is not None:
                assert len(w) == len(datasets[d][0]), (
                    f"dataset {d}: {len(w)} weights for "
                    f"{len(datasets[d][0])} records")
                self.record_weights[d] = np.asarray(w, np.float64).cumsum()

    def _sample_records(self) -> Iterator[tuple]:
        rng = random.Random(self.seed + self.process_index)
        orders = [list(range(len(ds[0]))) for ds in self.datasets]
        cursors = [len(o) for o in orders]  # trigger shuffle on first use
        i = 0
        while True:
            d = rng.choices(range(len(self.datasets)), weights=self.ratios)[0]
            if i % self.process_count == self.process_index:
                cum = self.record_weights[d]
                if cum is not None:
                    # weighted-with-replacement (reference multinomial)
                    j = bisect.bisect_left(cum, rng.random() * cum[-1])
                    yield d, self.datasets[d][0][min(j, len(cum) - 1)]
                else:
                    if cursors[d] >= len(orders[d]):
                        rng.shuffle(orders[d])
                        cursors[d] = 0
                    yield d, self.datasets[d][0][orders[d][cursors[d]]]
                    cursors[d] += 1
            else:
                cursors[d] = (cursors[d] + 1) % max(len(orders[d]), 1)
            i += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # map records on a thread pool (the reference uses worker processes;
        # PIL decode + numpy release the GIL so threads overlap fine), then
        # group by (dataset, bucket) and flush full batches
        from concurrent.futures import ThreadPoolExecutor

        def mapped():
            rec_iter = self._sample_records()
            with ThreadPoolExecutor(max_workers=max(self.num_workers, 1)) as ex:
                pending = []
                # per-draw aug seed keyed by the DRAW INDEX, not id(record):
                # object addresses differ between otherwise-identical runs,
                # which silently made "seed=0" loaders non-reproducible
                for i, (d, record) in enumerate(rec_iter):
                    seed = random.Random(self.seed ^ hash((d, i)))
                    pending.append((d, ex.submit(self.datasets[d][1], record,
                                                 seed)))
                    if len(pending) >= 2 * self.num_workers + 1:
                        d0, fut = pending.pop(0)
                        yield d0, fut.result()
                for d0, fut in pending:
                    yield d0, fut.result()

        groups: Dict[tuple, List[MappedSample]] = {}
        for d, sample in mapped():
            # video mappers emit (key, ref) MappedSample pairs; bucket by the
            # key frame (clip-consistent aug gives both frames one bucket)
            is_pair = isinstance(sample, tuple)
            key = (d, (sample[0] if is_pair else sample).bucket)
            groups.setdefault(key, []).append(sample)
            if len(groups[key]) == self.datasets[d][2]:
                batch = groups.pop(key)
                out = collate_video(batch) if is_pair else collate(batch)
                if len(self.datasets[d]) > 3:
                    out["__task__"] = self.datasets[d][3]
                yield out


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch so host mapping overlaps device compute."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        for item in iterator:
            q.put(item)
        q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
