"""The port's copy of the record format and reader
(tf_operator_tpu_torch.data.loader) against the JAX package's
tf_operator_tpu/data/loader.py on its Python path.

Exact: the bytes write_records writes, and every batch RecordLoader
yields, for several files, two epochs, shuffled and in order, one shard
and three; the errors carry JAX's words; train_llama's record pipeline
yields the rows as int32 token tensors.
"""
import os

import numpy as np
import pytest
import torch

from tf_operator_tpu.data import loader as jloader
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.data import loader as tloader

FIELDS = [("tokens", (12,), "int32"), ("label", (), "uint8"),
          ("mask", (2, 3), "float32")]
SIZES = (7, 5, 9)  # records per file: 21 in all, not a multiple of 2 or 3


def _fields(mod):
    return [mod.FieldSpec(n, s, d) for n, s, d in FIELDS]


def _columns(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 32000, (n, 12)),
            "label": rng.integers(0, 256, (n,)),
            "mask": rng.standard_normal((n, 2, 3))}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same seeded columns written by both sides: (port paths, JAX
    paths)."""
    root = tmp_path_factory.mktemp("records")
    out = {"port": [], "jax": []}
    for i, n in enumerate(SIZES):
        cols = _columns(n, 40 + i)
        for side, mod in (("port", tloader), ("jax", jloader)):
            path = str(root / f"{side}-{i}.rec")
            assert mod.write_records(path, _fields(mod), cols) == n
            out[side].append(path)
    return out["port"], out["jax"]


def test_write_records_writes_jax_bytes(shards):
    for mine, theirs in zip(*shards):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        assert tloader.read_header(mine) == jloader.read_header(theirs)
    assert tloader.MAGIC == jloader.MAGIC
    assert tloader.HEADER.format == jloader.HEADER.format
    assert (tloader.record_size(_fields(tloader))
            == jloader.record_size(_fields(jloader)) == 12 * 4 + 1 + 6 * 4)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n_shards,shard_id",
                         [(1, 0), (3, 0), (3, 1), (3, 2)])
def test_record_loader_yields_jax_batches(shards, n_shards, shard_id,
                                          shuffle):
    """Two epochs and a batch into the third, batch 2, seed 5."""
    mine_paths, theirs_paths = shards
    kw = dict(shuffle=shuffle, seed=5, shard_id=shard_id, n_shards=n_shards,
              loop=True)
    mine = tloader.RecordLoader(mine_paths, _fields(tloader), 2, **kw)
    theirs = jloader.RecordLoader(theirs_paths, _fields(jloader), 2,
                                  force_python=True, **kw)
    assert mine.num_records() == theirs.num_records()
    per_epoch = mine.num_records() // 2
    got, want = iter(mine), iter(theirs)
    for _ in range(2 * per_epoch + 1):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_record_loader_stops_after_one_epoch_without_loop(shards):
    mine_paths, theirs_paths = shards
    mine = list(tloader.RecordLoader(mine_paths, _fields(tloader), 4,
                                     loop=False, seed=1))
    theirs = list(jloader.RecordLoader(theirs_paths, _fields(jloader), 4,
                                       loop=False, seed=1,
                                       force_python=True))
    assert len(mine) == len(theirs) == sum(SIZES) // 4
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def _error(fn):
    with pytest.raises((ValueError, SystemExit)) as e:
        fn()
    return type(e.value), str(e.value)


def test_errors_carry_jax_words(shards, tmp_path):
    mine_paths, theirs_paths = shards
    wrong = {"port": [tloader.FieldSpec("tokens", (13,), "int32")],
             "jax": [jloader.FieldSpec("tokens", (13,), "int32")]}
    got = _error(lambda: tloader.RecordLoader(mine_paths, wrong["port"], 2))
    want = _error(lambda: jloader.RecordLoader(theirs_paths, wrong["jax"], 2,
                                               force_python=True))
    assert got[0] is want[0] is ValueError
    assert got[1] == want[1].replace("jax-", "port-")
    assert "record_size 73 != field spec total 52" in got[1]
    # 21 records over 3 shards: shard 2 holds 7 < 8
    got = _error(lambda: tloader.RecordLoader(
        mine_paths, _fields(tloader), 8, shard_id=2, n_shards=3))
    want = _error(lambda: jloader.RecordLoader(
        theirs_paths, _fields(jloader), 8, shard_id=2, n_shards=3,
        force_python=True))
    assert got == want
    assert "shard 2/3 holds 7 records < batch_size 8" in got[1]
    empty = str(tmp_path)
    got = _error(lambda: tloader.host_record_batches(
        empty, _fields(tloader), 2, lambda r: r))
    want = _error(lambda: jloader.host_record_batches(
        empty, _fields(jloader), 2, None, lambda r: r))
    assert got == want == (SystemExit, f"no .rec files under {empty}")
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"NOTAREC!" + bytes(16))
    got = _error(lambda: tloader.read_header(str(bad)))
    want = _error(lambda: jloader.read_header(str(bad)))
    assert got == want


def test_token_record_pipeline_yields_int32_rows(tmp_path, capsys):
    """train_llama's pipeline over shard (1, 2): the rows of JAX's
    loader for that shard, as [batch, seq_len] int32 tensors on the
    CPU, looping past the epoch."""
    rng = np.random.default_rng(3)
    fields = [tloader.FieldSpec("tokens", (16,), "int32")]
    for i in range(2):
        tloader.write_records(str(tmp_path / f"s{i}.rec"), fields,
                              {"tokens": rng.integers(0, 256, (9, 16))})
    it = ttl.token_record_pipeline(str(tmp_path), 4, 16, (1, 2),
                                   device="cpu")
    assert "data: records x9 (shard 1/2)" in capsys.readouterr().out
    paths = sorted(str(p) for p in tmp_path.glob("*.rec"))
    want = iter(jloader.RecordLoader(
        paths, [jloader.FieldSpec("tokens", (16,), "int32")], 4,
        shard_id=1, n_shards=2, force_python=True))
    for _ in range(5):  # two batches an epoch
        (tokens,) = next(it)
        assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
        np.testing.assert_array_equal(tokens.numpy(), next(want)["tokens"])
    assert os.path.basename(paths[0]) == "s0.rec"
