"""Engine — process topology, the process group and ``bigdl.*``
properties (counterpart of ``bigdl_tpu/utils/engine.py``; reference
utils/Engine.scala:93).

The reference ``Engine`` derives a node count × core count topology from
the Spark conf; the JAX package derives it from one controller over a
device mesh.  The port runs one process per CUDA device, as ``torchrun``
does, so a node is one process of the ``torch.distributed`` process
group and its core is its one device: ``node_number()`` is the world
size and ``core_number()`` is 1 unless ``bigdl.node.number`` /
``bigdl.core.number`` (env ``BIGDL_NODE_NUMBER``/``BIGDL_CORE_NUMBER``)
say otherwise.

The group's backend follows the device: a CUDA device uses NCCL, the
CPU (``device="cpu"``) gloo.  The mesh factory returns a
``torch.distributed.device_mesh.DeviceMesh`` with one dimension named
``"data"`` over every rank; the model axes (``model``, ``seq``,
``pipe``) are not ported yet and raise.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

log = logging.getLogger("bigdl_tpu_torch")

#: the backend a device's collectives run on; there is no other pairing
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def get_property(name: str, default=None):
    """``bigdl.*`` system properties become env vars: bigdl.foo → BIGDL_FOO."""
    env = name.replace(".", "_").upper()
    return os.environ.get(env, os.environ.get(name, default))


def _group_backends() -> dict:
    """The initialized group's backend by device type: ``"gloo"`` →
    ``{"cpu": "gloo", "cuda": "gloo"}``, ``"cpu:gloo,cuda:nccl"`` →
    ``{"cpu": "gloo", "cuda": "nccl"}``."""
    backend = str(dist.get_backend())
    if ":" not in backend:
        return {"cpu": backend, "cuda": backend}
    return dict(part.split(":", 1) for part in backend.split(","))


def check_device_backend(device: torch.device):
    """Raise unless the initialized group runs ``device``'s collectives
    on its own backend (NCCL for a CUDA device, gloo for the CPU): a
    CUDA model in a gloo group, or a CPU model in an NCCL group, has no
    path and no fallback."""
    want = BACKENDS[device.type]
    got = _group_backends().get(device.type)
    if got != want:
        raise RuntimeError(
            f"a model on {device} needs a {want!r} process group; this "
            f"process's group runs {device.type} collectives on {got!r} "
            f"(start the group with the model's device: "
            f"Engine.init_distributed(device=...))")


class Engine:
    """Process-wide topology singleton (reference utils/Engine.scala)."""

    _initialized = False
    _node_number = 1
    _core_number = 1
    _mesh = None
    #: the device the process group was started for (None: no group
    #: started by the Engine)
    _device: Optional[torch.device] = None
    engine_type = "cuda"

    @classmethod
    def init(cls, node_number: Optional[int] = None,
             core_number: Optional[int] = None, on_spark: bool = False):
        """A node is a process of the group (one without a group), its
        core its one device.  Explicit arguments are honoured for tests
        that simulate a topology."""
        if node_number is None:
            node_number = int(get_property(
                "bigdl.node.number",
                dist.get_world_size() if dist.is_initialized() else 1))
        if core_number is None:
            core_number = int(get_property("bigdl.core.number", 1))
        cls._node_number = node_number
        cls._core_number = core_number
        cls._initialized = True
        return cls

    @classmethod
    def init_distributed(cls, coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: DeviceLike = None,
                         timeout: Optional[float] = None):
        """Join this process to the ``torch.distributed`` group, then
        discover topology (the JAX package's ``jax.distributed``
        bring-up).  Arguments fall back to the ``bigdl.coordinator.*``
        properties, then to torchrun's env (``MASTER_ADDR``/``_PORT``,
        ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); with none of them this
        process is a group of one.

        ``coordinator_address``: ``host:port`` (a TCP store on rank 0),
        or an init method URL (``tcp://``, ``file://``, ``env://``).
        ``device``: the device this process drives; the default is the
        CUDA device ``LOCAL_RANK`` (else the current one), made current.
        A CUDA device gets an NCCL group, ``"cpu"`` a gloo group.
        ``timeout``: seconds a collective may wait (the backend's
        default otherwise).  Re-entrant: a second call checks that the
        group serves ``device`` and starts nothing."""
        env = os.environ
        if device is None and "LOCAL_RANK" in env \
                and torch.cuda.is_available():
            device = torch.device("cuda", int(env["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        dev = resolve_device(device)
        if dist.is_initialized():
            check_device_backend(dev)
            return cls.init()
        addr = (coordinator_address
                or get_property("bigdl.coordinator.address"))
        n = (num_processes if num_processes is not None
             else get_property("bigdl.coordinator.num.processes",
                               env.get("WORLD_SIZE")))
        pid = (process_id if process_id is not None
               else get_property("bigdl.coordinator.process.id",
                                 env.get("RANK")))
        n = 1 if n is None else int(n)
        pid = 0 if pid is None else int(pid)
        kwargs = dict(world_size=n, rank=pid)
        if timeout is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
        if addr is not None:
            kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
        elif "MASTER_ADDR" in env:
            kwargs["init_method"] = "env://"
        elif n == 1:
            # a group of one needs no rendezvous: an in-process store
            kwargs["store"] = dist.HashStore()
        else:
            raise ValueError(
                f"{n} processes need a coordinator address (an argument, "
                "bigdl.coordinator.address or torchrun's MASTER_ADDR)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(BACKENDS[dev.type], **kwargs)
        cls._device = dev
        cls._mesh = None
        return cls.init()

    @classmethod
    def node_number(cls) -> int:
        cls._ensure()
        return cls._node_number

    @classmethod
    def core_number(cls) -> int:
        cls._ensure()
        return cls._core_number

    @classmethod
    def device_count(cls) -> int:
        cls._ensure()
        return cls._node_number * cls._core_number

    @classmethod
    def _ensure(cls):
        if not cls._initialized:
            cls.init()

    @classmethod
    def check_singleton(cls) -> bool:
        """Reference Engine.checkSingleton (Engine.scala:165) guards one
        BigDL instance per executor; here one Engine per process."""
        return cls._initialized

    # ------------------------------------------------------------------
    # the mesh factory
    # ------------------------------------------------------------------
    @classmethod
    def create_mesh(cls, data: Optional[int] = None, model: int = 1,
                    seq: int = 1, pipe: int = 1, devices=None,
                    device: DeviceLike = None):
        """A one-dimensional ``DeviceMesh`` named ``("data",)`` over every
        rank of the process group; without a group, this process starts
        one (``init_distributed(device=device)``: alone unless torchrun's
        env or the ``bigdl.coordinator.*`` properties name others).
        ``data``, when given, must be the world size."""
        from torch.distributed.device_mesh import init_device_mesh

        for axis, size in (("model", model), ("seq", seq), ("pipe", pipe)):
            if size > 1:
                raise NotImplementedError(
                    f"a {axis!r} mesh axis of {size} is not ported to "
                    "bigdl_tpu_torch yet (ROADMAP Queue 1 item 5d: the "
                    "model, seq and pipe axes); the port's mesh has the "
                    "data axis only")
        if devices is not None:
            raise NotImplementedError(
                "a mesh over chosen devices: each process of the port "
                "drives its one device, so the mesh is the process group")
        if not dist.is_initialized():
            cls.init_distributed(device=device)
            log.info("Engine.create_mesh: started a group of one on %s "
                     "(%s)", cls._device, dist.get_backend())
        n = dist.get_world_size()
        if data is not None and int(data) != n:
            raise ValueError(f"mesh data={data} != {n} processes in the "
                             "group")
        dev_type = (cls._device.type if cls._device is not None else
                    "cuda" if "nccl" in str(dist.get_backend()) else "cpu")
        return init_device_mesh(dev_type, (n,), mesh_dim_names=("data",))

    @classmethod
    def default_mesh(cls, device: DeviceLike = None):
        cls._ensure()
        if cls._mesh is None:
            cls._mesh = cls.create_mesh(device=device)
        return cls._mesh

    @classmethod
    def set_default_mesh(cls, mesh):
        cls._mesh = mesh

    @classmethod
    def reset(cls):
        """Forget the topology and the mesh, and destroy the process
        group."""
        if dist.is_initialized():
            dist.destroy_process_group()
        cls._initialized = False
        cls._mesh = None
        cls._device = None
        cls._node_number = 1
        cls._core_number = 1


def init_engine(*args, **kwargs):
    """pyspark parity: ``init_engine()`` (pyspark/bigdl/util/engine.py)."""
    return Engine.init(*args, **kwargs)
