"""TPUREC01 record files and the batch loader over them.

The port's copy of tf_operator_tpu/data/loader.py (numpy only; the port
imports nothing of the JAX package), on its Python reader:

  8B magic 'TPUREC01' | u64 record_size | u64 n_records | payload.

A record is the concatenation of fixed-size fields (FieldSpec); a batch of
N records viewed field-wise gives arrays [N, *field.shape] with zero
parsing.  `write_records` writes the same bytes as the JAX package's, and
`RecordLoader` yields the same batches as its Python path
(`force_python=True`): round-robin shard assignment, drop-remainder
batches, a per-epoch shuffle seeded with seed + epoch.  The C++ reader
(native/dataloader.cc) is not bound: its shuffle order differs from the
Python path's by design.  The shard is given explicitly (shard_id,
n_shards); reading it from the PyTorchJob env comes with the
multi-process bootstrap.
"""
from __future__ import annotations

import glob
import os
import struct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

MAGIC = b"TPUREC01"
HEADER = struct.Struct("<8sQQ")


@dataclass(frozen=True)
class FieldSpec:
    name: str
    shape: Tuple[int, ...]
    dtype: str  # numpy dtype string, e.g. 'uint8', 'int32'

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, initial=1)) * np.dtype(self.dtype).itemsize


def record_size(fields: Sequence[FieldSpec]) -> int:
    return sum(f.nbytes for f in fields)


def write_records(path: str, fields: Sequence[FieldSpec],
                  columns: Dict[str, np.ndarray]) -> int:
    """Write one record file. `columns[name]` is [N, *shape] for each field;
    all N equal. Returns N."""
    ns = {f.name: len(columns[f.name]) for f in fields}
    n = next(iter(ns.values()))
    if any(v != n for v in ns.values()):
        raise ValueError(f"unequal column lengths: {ns}")
    rsize = record_size(fields)
    with open(path, "wb") as out:
        out.write(HEADER.pack(MAGIC, rsize, n))
        for i in range(n):
            for f in fields:
                # NB: ascontiguousarray promotes 0-d to 1-d; asarray doesn't
                arr = np.asarray(columns[f.name][i], dtype=f.dtype, order="C")
                if arr.shape != tuple(f.shape):
                    raise ValueError(
                        f"{f.name}[{i}]: shape {arr.shape} != spec {f.shape}"
                    )
                out.write(arr.tobytes())
    return n


def read_header(path: str) -> Tuple[int, int]:
    """-> (record_size, n_records); raises on bad magic."""
    with open(path, "rb") as f:
        magic, rsize, n = HEADER.unpack(f.read(HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"{path}: not a TPUREC01 file")
    return rsize, n


def host_record_batches(data_dir: str, fields: Sequence[FieldSpec],
                        batch_size: int, map_fn: Callable,
                        shard_id: int = 0, n_shards: int = 1):
    """The on-disk input scaffold: glob the .rec shards under `data_dir`
    (failing loudly on an empty dir), build the loader EAGERLY — a wrong
    path or an undersized shard fails at startup, not at the first batch
    — print the shard line, and yield map_fn(record) batches forever."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.rec")))
    if not paths:
        raise SystemExit(f"no .rec files under {data_dir}")
    loader = RecordLoader(paths, fields, batch_size, shuffle=True, loop=True,
                          shard_id=shard_id, n_shards=max(1, n_shards))
    print(f"data: records x{loader.num_records()} "
          f"(shard {loader.shard_id}/{loader.n_shards})")

    def batches():
        for rec in loader:
            yield map_fn(rec)

    return batches()


def _split_batch(buf: np.ndarray, batch_size: int,
                 fields: Sequence[FieldSpec]) -> Dict[str, np.ndarray]:
    """View a [batch_size * record_size] byte buffer field-wise (zero copy)."""
    rec = buf.reshape(batch_size, -1)
    out: Dict[str, np.ndarray] = {}
    off = 0
    for f in fields:
        chunk = rec[:, off: off + f.nbytes]
        out[f.name] = chunk.view(f.dtype).reshape((batch_size,) + tuple(f.shape))
        off += f.nbytes
    return out


class RecordLoader:
    """Iterate batches from record files.

    Yields {field: np.ndarray [B, *shape]}. Drop-remainder; seeded per-epoch
    shuffle.  Shard DISJOINTNESS comes from the round-robin record->shard
    assignment (record i belongs to shard i % n_shards), NOT from the
    shuffle: each host only ever permutes its own shard."""

    def __init__(self, paths: Sequence[str], fields: Sequence[FieldSpec],
                 batch_size: int, *, shuffle: bool = True, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1,
                 loop: bool = True) -> None:
        if not paths:
            raise ValueError("no record files")
        self.paths = [os.fspath(p) for p in paths]
        self.fields = list(fields)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.loop = loop

        rsize = record_size(self.fields)
        for p in self.paths:
            got, _ = read_header(p)
            if got != rsize:
                raise ValueError(
                    f"{p}: record_size {got} != field spec total {rsize}"
                )
        self._rsize = rsize

        # a shard smaller than one batch can never produce a full batch
        # (records never repeat within a batch): fail loudly
        n_mine = self._shard_count()
        if n_mine < batch_size:
            raise ValueError(
                f"shard {shard_id}/{n_shards} holds {n_mine} records "
                f"< batch_size {batch_size}: can never produce a batch"
            )

    def _shard_count(self) -> int:
        total = sum(read_header(p)[1] for p in self.paths)
        return total // self.n_shards + (
            1 if total % self.n_shards > self.shard_id else 0
        )

    def num_records(self) -> int:
        return self._shard_count()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Every __iter__ is an independent fresh stream from the start."""
        index: List[Tuple[int, int]] = []
        counts = [read_header(p)[1] for p in self.paths]
        g = 0
        for fi, n in enumerate(counts):
            for r in range(n):
                if g % self.n_shards == self.shard_id:
                    index.append((fi, r))
                g += 1
        handles = [open(p, "rb") for p in self.paths]
        try:
            epoch = 0
            while True:
                order = np.arange(len(index))
                if self.shuffle:
                    np.random.default_rng(self.seed + epoch).shuffle(order)
                for s in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                    buf = np.empty(self.batch_size * self._rsize, np.uint8)
                    for j, oi in enumerate(order[s: s + self.batch_size]):
                        fi, r = index[oi]
                        handles[fi].seek(HEADER.size + r * self._rsize)
                        chunk = handles[fi].read(self._rsize)
                        buf[j * self._rsize: (j + 1) * self._rsize] = (
                            np.frombuffer(chunk, np.uint8))
                    yield _split_batch(buf, self.batch_size, self.fields)
                if not self.loop:
                    return
                epoch += 1
        finally:
            for h in handles:
                h.close()
