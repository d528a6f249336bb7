"""The port's serving journal (``repro_torch.parallel.journal``) against the
reference's (``repro.parallel.journal``): the same files, dtypes and
``meta.json`` fields, so either package drains the other's journal.

Tolerance: bitwise (file bytes, drained results).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import BatchServer as JServer
from repro.parallel.journal import ChunkJournal as JJournal
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.parallel import BatchServer
from repro_torch.parallel.journal import ChunkJournal, key_words, write_json_durable


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


B, M, N, S = 4, 16, 32, 3


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _chunk(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, M)).astype(np.float32),
            rng.standard_normal((B, N)).astype(np.float32))


def _files(d):
    return sorted(os.listdir(d))


def _write(journal, key, mask, seed=0):
    Y, x = _chunk(seed)
    journal.record_submit(3, Y, key, mask, extra={"rid": 3, "priority": 1})
    journal.record_result(3, x, mask)


@pytest.mark.parametrize("mask", [None, [True, False, True, True]])
def test_journal_files_are_the_reference_s(tmp_path, mask):
    """Both packages journal one chunk (the port from tensors and its int64
    key): the same file names, each file byte for byte."""
    jk = jax.random.PRNGKey(11)
    _write(JJournal(str(tmp_path / "jax")), np.asarray(jk), mask)
    Y, x = _chunk()
    tj = ChunkJournal(str(tmp_path / "torch"))
    tj.record_submit(3, torch.from_numpy(Y), convert.key_from_numpy(np.asarray(jk)),
                     None if mask is None else torch.tensor(mask),
                     extra={"rid": 3, "priority": 1})
    tj.record_result(3, torch.from_numpy(x), mask)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "torch")
    assert ("chunk_000003.mask.npy" in names) == (mask is not None)
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert a == b, name
    assert json.loads((tmp_path / "torch" / "chunk_000003.meta.json").read_text())[
        "key_dtype"] == "uint32"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_either_package_reads_the_other_s_journal(tmp_path, writer):
    mask = [True, True, False, True]
    jk = jax.random.PRNGKey(5)
    tk = convert.key_from_numpy(np.asarray(jk))
    w, r = ((JJournal, ChunkJournal) if writer == "jax" else (ChunkJournal, JJournal))
    _write(w(str(tmp_path)), np.asarray(jk) if writer == "jax" else tk, mask)
    reader = r(str(tmp_path))
    Y, x = _chunk()
    assert reader.is_complete(3) and reader.completed() == [3] and reader.pending() == []
    reader.verify_submit(3, Y, np.asarray(jk) if writer == "torch" else tk, mask)
    full = reader.load_result_full(3)
    np.testing.assert_array_equal(full[[0, 1, 3]], x[[0, 1, 3]])
    assert not full[2].any()
    assert reader.load_submit(3)[1].dtype == np.uint32


def test_key_words():
    key = prng.PRNGKey(302)
    words = key_words(key)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, np.asarray(jax.random.PRNGKey(302)))
    np.testing.assert_array_equal(key_words(words), words)
    with pytest.raises(ValueError, match="uint32"):
        key_words(torch.tensor([-1, 3]))
    with pytest.raises(ValueError, match="two uint32 words"):
        key_words(torch.zeros(3, dtype=torch.int64))


def test_verify_submit_refuses_another_stream(tmp_path):
    j = ChunkJournal(str(tmp_path))
    Y, _ = _chunk()
    key = prng.PRNGKey(1)
    j.record_submit(0, Y, key)
    j.record_submit(0, torch.from_numpy(Y), key)          # a replay verifies, idempotent
    with pytest.raises(ValueError, match="Y differs"):
        j.verify_submit(0, Y + 1, key)
    with pytest.raises(ValueError, match="key"):
        j.verify_submit(0, Y, prng.PRNGKey(2))
    with pytest.raises(ValueError, match="mask"):
        j.verify_submit(0, Y, key, [True, False, True, True])
    with pytest.raises(ValueError, match="row_mask shape"):
        j.record_submit(1, Y, key, [True])


def test_all_true_mask_is_none_and_torn_markers_demote(tmp_path):
    j = ChunkJournal(str(tmp_path))
    Y, x = _chunk()
    j.record_submit(0, Y, prng.PRNGKey(0), [True] * B)
    assert j.load_mask(0) is None and j.pending() == [0]
    j.record_result(0, x)
    assert j.completed() == [0]
    (tmp_path / "chunk_000000.done.json").write_text("{torn")
    assert not j.is_complete(0) and j.pending() == [0]


def test_write_json_durable_leaves_no_tmp(tmp_path):
    p = str(tmp_path / "m.json")
    write_json_durable(p, {"a": 1})
    assert json.loads(open(p).read()) == {"a": 1} and _files(tmp_path) == ["m.json"]


def _server_problem():
    rng = np.random.default_rng(3)
    phi = (rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
    X = np.zeros((B, N), np.float32)
    for b in range(B):
        X[b, rng.choice(N, S, replace=False)] = rng.standard_normal(S)
    return phi, (X @ phi.T).astype(np.float32)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_batch_server_drains_the_other_package_s_journal(tmp_path, writer):
    """One package serves two chunks journaled, the other resumes on the same
    directory: both chunks drained, their x the writer's bytes."""
    phi, Y = _server_problem()
    jk = jax.random.PRNGKey(4)
    tk = convert.key_from_numpy(np.asarray(jk))
    kw = dict(bits_phi=4, bits_y=8, backend="packed", journal_dir=str(tmp_path))
    mask = [True, False, True, True]
    if writer == "jax":
        srv = JServer(_j(phi), S, 10, key=jk, **kw)
        first = [np.asarray(srv.submit(_j(Y)).x),
                 np.asarray(srv.submit(_j(Y * 0.5), row_mask=np.asarray(mask)).x)]
        other = BatchServer(torch.from_numpy(phi), S, 10, key=tk, resume=True, **kw)
        again = [other.submit(torch.from_numpy(Y)).x.numpy(),
                 other.submit(torch.from_numpy(Y * 0.5), row_mask=torch.tensor(mask)).x.numpy()]
    else:
        srv = BatchServer(torch.from_numpy(phi), S, 10, key=tk, **kw)
        first = [srv.submit(torch.from_numpy(Y)).x.numpy(),
                 srv.submit(torch.from_numpy(Y * 0.5), row_mask=torch.tensor(mask)).x.numpy()]
        other = JServer(_j(phi), S, 10, key=jk, resume=True, **kw)
        again = [np.asarray(other.submit(_j(Y)).x),
                 np.asarray(other.submit(_j(Y * 0.5), row_mask=np.asarray(mask)).x)]
    assert other.n_drained == 2
    for a, b in zip(first, again):
        assert a.tobytes() == b.tobytes()
