"""The port's verified checkpoints against the JAX package on the CPU:
the native crc32c (built from ``bigdl_tpu_torch/native/crc32c.cc`` at
first use) against the pure-Python table and the JAX package's crc; the
sidecars, their verification and the walk-back restore across both
packages; ``utils.file_io``'s backends, serialization and atomic writes;
the background checkpoint writer.
"""
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.resilience import checkpoint as jckpt
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu.visualization.crc32c import crc32c as jax_crc32c
from bigdl_tpu_torch import native
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.resilience import checkpoint as ckpt
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.async_checkpoint import (
    AsyncCheckpointError, AsyncCheckpointWriter)
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.tree import tree_leaves
from bigdl_tpu_torch.visualization.crc32c import crc32c, crc32c_table

torch.set_num_threads(1)

# every join and drain below has a timeout, so no test can hang the run
TIMEOUT = 10.0


def _bytes(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=n, dtype=np.uint8).tobytes()


# ----------------------------------------------------------------------
# the native crc32c
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4097, (1 << 20) + 3])
def test_native_crc_equals_the_table_and_the_jax_package(n):
    data = _bytes(n, seed=n)
    want = crc32c_table(data)
    assert native.crc32c(data) == want
    assert crc32c(data) == want
    assert jax_crc32c(data) == want
    # a running crc over two pieces equals the crc of the whole, and a
    # nonzero start continues the table's stream
    cut = n // 3
    assert crc32c(data[cut:], crc32c(data[:cut])) == want
    assert crc32c(data, 0x1234ABCD) == crc32c_table(data, 0x1234ABCD)


def test_native_crc_reads_any_buffer_in_place():
    data = _bytes(4099, seed=3)
    want = crc32c_table(data)
    assert crc32c(bytearray(data)) == want
    assert crc32c(memoryview(data)) == want
    assert crc32c(np.frombuffer(data, np.uint8)) == want
    assert crc32c(memoryview(b"x" + data)[1:]) == want
    assert crc32c(b"123456789") == 0xE3069283     # the CRC-32C check value


def test_native_build_failure_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "crc32c.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="crc32c.cc failed"):
        native.crc32c(b"abc")


# ----------------------------------------------------------------------
# sidecars and verification, across the two packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", ["bit_flip", "truncate"])
def test_sidecars_equal_and_verify_across_packages(tmp_path, writer, damage):
    data = _bytes(70_001, seed=5)
    mine, theirs = str(tmp_path / "model.3"), str(tmp_path / "j" / "model.3")
    file_io.save_bytes(data, mine)
    jfile_io.save_bytes(data, theirs)
    assert open(ckpt.sidecar_path(mine), "rb").read() == \
        open(jckpt.sidecar_path(theirs), "rb").read()
    path = mine if writer == "port" else theirs
    assert open(path, "rb").read() == data
    assert ckpt.verify_file(path) is True
    assert jckpt.verify_file(path) is True
    if damage == "bit_flip":
        faults.bit_flip(path)
    else:
        faults.truncate(path, keep_fraction=0.5)
    assert ckpt.verify_file(path) is False
    assert jckpt.verify_file(path) is False


def _walk_dir(root):
    """model.N files whose payloads are pickled numpy dicts (both
    packages unpickle them), some corrupted, one without a sidecar."""
    for n in (3, 8, 12, 32, 100):
        payload = {"w": np.full((4, 3), float(n), np.float32),
                   "step": np.int64(n)}
        jfile_io.save(payload, os.path.join(root, f"model.{n}"),
                      atomic=True, checksum=True)
    jfile_io.save({"w": np.zeros(2, np.float32)},
                  os.path.join(root, "model.5"))            # legacy, no crc
    faults.bit_flip(os.path.join(root, "model.100"))
    faults.truncate(os.path.join(root, "model.32"), keep_fraction=0.4)
    open(os.path.join(root, "model.x"), "wb").write(b"not a step")


@pytest.mark.parametrize("max_step", [None, 31, 7])
def test_walk_back_picks_the_same_step_and_quarantines_the_same(
        tmp_path, max_step):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    _walk_dir(str(mine))
    shutil.copytree(mine, theirs)
    got, got_path = ckpt.verify_and_load_latest(str(mine), "model",
                                                max_step=max_step)
    want, want_path = jckpt.verify_and_load_latest(str(theirs), "model",
                                                   max_step=max_step)
    assert os.path.basename(got_path) == os.path.basename(want_path)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    expect = {None: "model.12", 31: "model.12", 7: "model.5"}[max_step]
    assert os.path.basename(got_path) == expect
    assert [os.path.basename(p) for p in ckpt.candidate_files(
        str(mine), "model")] == [os.path.basename(p) for p in
                                 jckpt.candidate_files(str(theirs), "model")]


def test_verified_load_quarantines_and_raises_typed(tmp_path):
    p = str(tmp_path / "model.1")
    file_io.save({"w": torch.ones(3)}, p, atomic=True, checksum=True)
    assert ckpt.verified_load(p)["w"].tolist() == [1.0, 1.0, 1.0]
    faults.bit_flip(p)
    with pytest.raises(ckpt.CorruptCheckpointError, match="crc32c"):
        ckpt.verified_load(p)
    assert os.path.exists(p + ".corrupt")
    assert os.path.exists(ckpt.sidecar_path(p) + ".corrupt")
    assert not os.path.exists(p)


# ----------------------------------------------------------------------
# serialization
# ----------------------------------------------------------------------

def test_serialize_round_trips_tensors_as_their_own_bytes(tmp_path):
    big = torch.arange(1000, dtype=torch.float32).reshape(10, 100)
    tree = {"bf16": torch.linspace(-3, 3, 7).to(torch.bfloat16),
            "i32": torch.arange(5, dtype=torch.int32),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 3),
            "bool": torch.tensor([True, False]),
            "view": big[:, 3],                  # strided, 10 of 1000
            "param": torch.nn.Parameter(torch.ones(2)),
            "np": np.arange(3), "n": 7}
    data = file_io.serialize(tree)
    assert len(data) < 2000, "a view must not pickle its whole storage"
    p = str(tmp_path / "t")
    file_io.save(tree, p)
    back = file_io.load(p)
    for k in ("bf16", "i32", "scalar", "empty", "bool", "view"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k],
                                                               tree[k]), k
    assert type(back["param"]) is torch.Tensor
    assert not back["param"].requires_grad
    np.testing.assert_array_equal(back["np"], np.arange(3))
    assert back["n"] == 7
    # the bytes own nothing of the live tensors
    tree["view"].add_(1)
    assert torch.equal(file_io.load(p)["view"], big[:, 3] - 1)


def test_save_overwrite_contract_and_atomic_sidecar(tmp_path):
    p = str(tmp_path / "tree")
    file_io.save({"w": torch.ones(4, 4)}, p, atomic=True, checksum=True)
    assert ckpt.verify_file(p) is True
    with pytest.raises(FileExistsError):
        file_io.save({"w": torch.ones(1)}, p)
    faults.bit_flip(p)
    assert ckpt.verify_file(p) is False
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


def test_save_bytes_fails_cleanly_under_an_injected_io_fault(tmp_path):
    p = str(tmp_path / "model.4")
    with faults.io_faults("model.4", times=1) as entry:
        with pytest.raises(OSError, match="injected"):
            file_io.save_bytes(b"abc", p)
        file_io.save_bytes(b"abc", p)
    assert entry["remaining"] == 0
    assert ckpt.verify_file(p) is True


# ----------------------------------------------------------------------
# backends (tests/test_file_io_backends.py on a registered scheme)
# ----------------------------------------------------------------------

class DictBackend(file_io.FileSystemBackend):
    def __init__(self):
        self.store = {}

    def open(self, path, mode):
        import io

        if "w" in mode:
            buf = io.BytesIO()
            close = buf.close
            buf.close = lambda: (self.store.__setitem__(
                path, buf.getvalue()), close())
            return buf
        return io.BytesIO(self.store[path])

    def exists(self, path):
        return path in self.store

    def makedirs(self, path):
        pass

    def listdir(self, path):
        p = path.rstrip("/") + "/"
        return [k[len(p):] for k in self.store if k.startswith(p)
                and "/" not in k[len(p):]]

    def isdir(self, path):
        return bool(self.listdir(path))


@pytest.fixture
def dictfs():
    backend = DictBackend()
    file_io.register_filesystem("dictfs", backend)
    yield backend
    file_io._FILESYSTEMS.pop("dictfs", None)


def _tiny_tree():
    g = torch.Generator().manual_seed(0)
    return nn.Sequential(nn.Linear(3, 4, device="cpu", generator=g),
                         nn.Tanh(device="cpu"), device="cpu").param_tree()


class TestRegisteredScheme:
    def test_save_load_roundtrip(self, dictfs):
        tree = _tiny_tree()
        file_io.save(tree, "dictfs://ckpt/model_a", overwrite=True)
        back = file_io.load("dictfs://ckpt/model_a")
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            assert torch.equal(a, b)

    def test_overwrite_contract(self, dictfs):
        file_io.save(_tiny_tree(), "dictfs://ckpt/model_b", overwrite=True)
        with pytest.raises(FileExistsError):
            file_io.save(_tiny_tree(), "dictfs://ckpt/model_b")

    def test_listdir_isdir_join(self, dictfs):
        file_io.save(_tiny_tree(), "dictfs://ckpt2/model.3")
        file_io.save(_tiny_tree(), "dictfs://ckpt2/model.12")
        assert file_io.isdir("dictfs://ckpt2")
        assert {"model.3", "model.12"} <= set(file_io.listdir(
            "dictfs://ckpt2"))
        assert file_io.join("dictfs://ckpt2", "x") == "dictfs://ckpt2/x"

    def test_latest_file_numeric_ordering(self, dictfs):
        for n in (3, 12, 7):
            file_io.save(_tiny_tree(), f"dictfs://ckpt3/model.{n}",
                         atomic=True, checksum=True)
        assert ckpt.candidate_files("dictfs://ckpt3", "model")[0] == \
            "dictfs://ckpt3/model.12"
        got, path = ckpt.verify_and_load_latest("dictfs://ckpt3", "model")
        assert path == "dictfs://ckpt3/model.12" and "0" in got

    def test_training_checkpoints_to_a_registered_scheme(self, dictfs):
        rng = np.random.RandomState(0)
        samples = [Sample(rng.rand(3).astype(np.float32),
                          np.float32(rng.randint(1, 3))) for _ in range(32)]
        g = torch.Generator().manual_seed(0)
        model = nn.Sequential(nn.Linear(3, 2, device="cpu", generator=g),
                              nn.LogSoftMax(device="cpu"), device="cpu")
        opt = LocalOptimizer(model, array(samples), nn.ClassNLLCriterion(),
                             batch_size=16)
        opt.set_optim_method(SGD(learning_rate=0.1))
        opt.set_end_when(max_iteration(4))
        opt.set_checkpoint("dictfs://run1", several_iteration(2))
        opt.optimize()
        names = set(file_io.listdir("dictfs://run1"))
        assert {"model.2", "model.4", "optimMethod.4", "trainState.4"} <= \
            names
        leg, path = ckpt.verify_and_load_latest("dictfs://run1", "model")
        assert path == "dictfs://run1/model.4"
        assert torch.equal(leg["params"]["0"]["weight"],
                           model[0].weight.detach())

    def test_register_filesystem_and_unregistered_scheme(self, dictfs):
        file_io.save({"a": np.arange(3)}, "dictfs://bucket/obj")
        np.testing.assert_array_equal(
            file_io.load("dictfs://bucket/obj")["a"], [0, 1, 2])
        # an unknown scheme falls to fsspec, which does not know it
        # either: the JAX package's ValueError, naming the registry
        with pytest.raises(ValueError, match="register"):
            file_io.save({"a": 1}, "nosuchfs://bucket/obj")


# ----------------------------------------------------------------------
# the background writer (tests/test_async_overlap.py:68-150)
# ----------------------------------------------------------------------

def test_writer_commits_bytes_with_crc_and_drains(tmp_path):
    w = AsyncCheckpointWriter()
    p1, p2 = str(tmp_path / "model.5"), str(tmp_path / "optimMethod.5")
    blocked = w.submit(5, [(p1, b"params-bytes"), (p2, b"slots-bytes")])
    assert blocked >= 0.0
    assert w.drain(timeout=TIMEOUT)
    assert open(p1, "rb").read() == b"params-bytes"
    assert open(p2, "rb").read() == b"slots-bytes"
    assert ckpt.verify_file(p1) is True and ckpt.verify_file(p2) is True
    assert jckpt.verify_file(p1) is True
    assert w.writes == 1 and w.pending == 0
    w.close(timeout=TIMEOUT)


def test_writer_backpressure_blocks_and_reports_seconds(tmp_path):
    release, started = threading.Event(), threading.Event()

    def slow_write():
        started.set()
        assert release.wait(TIMEOUT)

    w = AsyncCheckpointWriter(queue_depth=1)
    w.submit(1, fn=slow_write)
    assert started.wait(TIMEOUT)
    t = threading.Timer(0.25, release.set)
    t.start()
    blocked = w.submit(2, [(str(tmp_path / "model.2"), b"x")])
    t.cancel()
    assert blocked >= 0.15, f"submit returned without waiting ({blocked})"
    assert w.drain(timeout=TIMEOUT)
    assert w.blocked_seconds >= 0.15
    w.close(timeout=TIMEOUT)


def test_writer_jobs_commit_in_submission_order(tmp_path):
    w = AsyncCheckpointWriter(queue_depth=1)
    p = str(tmp_path / "model")
    for n in range(8):
        w.submit(n, [(p, b"step-%d" % n)])
    assert w.drain(timeout=TIMEOUT)
    assert open(p, "rb").read() == b"step-7"
    assert ckpt.verify_file(p) is True
    assert w.writes == 8
    w.close(timeout=TIMEOUT)


def test_writer_error_surfaces_on_training_thread(tmp_path):
    w = AsyncCheckpointWriter()
    with faults.io_faults(str(tmp_path / "model"), times=1):
        w.submit(3, [(str(tmp_path / "model.3"), b"x")])
        assert w.drain(timeout=TIMEOUT, raise_errors=False)
        with pytest.raises(AsyncCheckpointError) as ei:
            w.submit(4, [(str(tmp_path / "model.4"), b"y")])
    assert "step 3" in str(ei.value)
    w.submit(4, [(str(tmp_path / "model.4"), b"y")])
    assert w.drain(timeout=TIMEOUT)
    assert os.path.exists(tmp_path / "model.4")
    assert not os.path.exists(tmp_path / "model.3")
    w.close(timeout=TIMEOUT)
