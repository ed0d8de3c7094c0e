"""IndexSampler — the deterministic heart of the pipeline (port of the
JAX package's ``data/sampler.py``: numpy only, the same permutations).

Reference: the per-partition index shuffle of
``CachedDistributedFeatureSet`` (FeatureSet.scala:229-329), rebuilt the
way Grain's ``IndexSampler`` does it: every host derives the SAME
global permutation from ``(seed, epoch)``, then takes only its own
shard of every batch.  Because the map ``(seed, epoch, step) ->
record indices`` is a pure function, the sampler needs no mutable
iterator state at all — a resumed run simply asks for step ``k+1``.

Sharding layout: global batch ``b`` is the contiguous permutation slice
``perm[b*G : (b+1)*G]`` (``G`` = batch_size x shard_count) and shard
``h`` owns rows ``[h*B : (h+1)*B]`` of it.  This matches the multi-host
placement convention of ``DistributedTrainer.put_batch`` (each
process's rows are one contiguous slice of the global batch, in process
order), so concatenating every shard's batch ``b`` reproduces the
single-host stream bit-for-bit — the cross-shard-count determinism
contract tier-1 asserts.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def process_shard() -> Tuple[int, int]:
    """``(rank, world size)`` of this process: ``torch.distributed``'s
    when a process group is initialized (the reference reads
    ``jax.process_index()``/``process_count()``), else ``(0, 1)``.
    ``torch`` is looked up, not imported: a process that never imported
    it has no group."""
    import sys
    dist = getattr(sys.modules.get("torch"), "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


class IndexSampler:
    """Deterministic, sharded, batched index generator.

    Args:
        num_records: size of the underlying source.
        batch_size: PER-SHARD batch size (rows this host consumes per
            step) — the same convention as ``Estimator.train``.
        shuffle: deterministic per-epoch shuffle when True, source
            order when False.
        seed: permutation seed (default: ``data.shuffle_seed`` config).
        shard_index / shard_count: this host's shard (defaults: the
            ``torch.distributed`` rank and world size when a process
            group is initialized, else 0 and 1).
        remainder: ``"drop"`` discards the trailing rows that cannot
            fill a whole global batch (training — the global batch must
            tile the mesh); ``"pad"`` emits a final short batch padded
            by repeating index 0, with a mask marking real rows (eval).
    """

    def __init__(self, num_records: int, batch_size: int, *,
                 shuffle: bool = True, seed: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 remainder: str = "drop"):
        if remainder not in ("drop", "pad"):
            raise ValueError(
                f"remainder {remainder!r}: expected 'drop'|'pad'")
        if shard_count is None or shard_index is None:
            rank, world = process_shard()
            shard_count = world if shard_count is None else shard_count
            shard_index = rank if shard_index is None else shard_index
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"shard_count {shard_count}")
        if seed is None:
            from analytics_zoo_torch.common.config import get_config
            seed = int(get_config().get("data.shuffle_seed"))
        self.num_records = int(num_records)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)
        self.remainder = remainder
        self.global_batch = self.batch_size * self.shard_count
        if self.num_records < self.global_batch and remainder == "drop":
            raise ValueError(
                f"{self.num_records} records cannot fill one global "
                f"batch of {self.global_batch} "
                f"({self.batch_size} x {self.shard_count} shards)")

    # ------------------------------------------------------------ geometry
    @property
    def num_batches(self) -> int:
        """Per-epoch steps every shard takes (identical across shards —
        SPMD programs must stay in step)."""
        if self.remainder == "drop":
            return self.num_records // self.global_batch
        return -(-self.num_records // self.global_batch)

    def epoch_perm(self, epoch: int) -> np.ndarray:
        """The GLOBAL record permutation for one epoch — same on every
        shard (same multiplier idiom as ``FeatureSet._epoch_perm`` so
        the two layers' epoch streams stay independently seeded but
        equally reproducible)."""
        if not self.shuffle:
            return np.arange(self.num_records)
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        return rng.permutation(self.num_records)

    # ------------------------------------------------------------- indexing
    def _slice_step(self, perm: np.ndarray, step: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """This shard's indices + real-row mask for one step of an
        epoch permutation — the ONE place the shard slice bounds and
        tail padding live (batch_indices and iter_epoch must never
        diverge: one is the resume primitive, the other the stream)."""
        g0 = step * self.global_batch
        lo = g0 + self.shard_index * self.batch_size
        hi = lo + self.batch_size
        sel = perm[lo:min(hi, self.num_records)]
        mask = np.ones(len(sel), np.float32)
        if len(sel) < self.batch_size:   # "pad" tail batch
            pad = self.batch_size - len(sel)
            sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        return sel, mask

    def batch_indices(self, epoch: int, step: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Record indices + real-row mask for this shard's batch at
        ``(epoch, step)`` — a pure function, the resume primitive."""
        nb = self.num_batches
        if not 0 <= step < nb:
            raise IndexError(
                f"step {step} out of range for epoch of {nb} batches")
        return self._slice_step(self.epoch_perm(epoch), step)

    def iter_epoch(self, epoch: int, start_step: int = 0
                   ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield ``(step, indices, mask)`` from ``start_step`` to the
        end of ``epoch``.  The permutation is computed once and sliced
        per step (not re-derived per batch)."""
        nb = self.num_batches
        if start_step >= nb:
            return
        perm = self.epoch_perm(epoch)
        for step in range(start_step, nb):
            sel, mask = self._slice_step(perm, step)
            yield step, sel, mask
