"""Engine — process topology and ``bigdl.*`` properties (counterpart of
``bigdl_tpu/utils/engine.py``, its single-device part; reference
utils/Engine.scala:93).

The reference ``Engine`` derives a node count × core count topology from
the Spark conf.  Here a node is this process's host and a core is one
CUDA device: ``Engine.init`` reads ``bigdl.node.number`` and
``bigdl.core.number`` (env ``BIGDL_NODE_NUMBER``/``BIGDL_CORE_NUMBER``)
and otherwise counts the CUDA devices.  The mesh factory
(``create_mesh``, ``default_mesh``, ``set_default_mesh``) and
``init_distributed`` come with the port's distributed slice and raise.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to bigdl_tpu_torch "
                               f"yet")


def get_property(name: str, default=None):
    """``bigdl.*`` system properties become env vars: bigdl.foo → BIGDL_FOO."""
    env = name.replace(".", "_").upper()
    return os.environ.get(env, os.environ.get(name, default))


class Engine:
    """Process-wide topology singleton (reference utils/Engine.scala)."""

    _initialized = False
    _node_number = 1
    _core_number = 1
    engine_type = "cuda"

    @classmethod
    def init(cls, node_number: Optional[int] = None,
             core_number: Optional[int] = None, on_spark: bool = False):
        """One node (this process); one core per CUDA device, at least
        one.  Explicit arguments are honoured for tests that simulate a
        topology."""
        if node_number is None:
            node_number = int(get_property("bigdl.node.number", 1))
        if core_number is None:
            core_number = int(get_property("bigdl.core.number",
                                           max(torch.cuda.device_count(), 1)))
        cls._node_number = node_number
        cls._core_number = core_number
        cls._initialized = True
        return cls

    @classmethod
    def init_distributed(cls, coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
        raise _not_ported("Engine.init_distributed (multi-process runs)")

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

    @classmethod
    def create_mesh(cls, data: Optional[int] = None, model: int = 1,
                    seq: int = 1, pipe: int = 1, devices=None):
        raise _not_ported("Engine.create_mesh (device meshes)")

    @classmethod
    def default_mesh(cls):
        raise _not_ported("Engine.default_mesh (device meshes)")

    @classmethod
    def set_default_mesh(cls, mesh):
        raise _not_ported("Engine.set_default_mesh (device meshes)")

    @classmethod
    def reset(cls):
        cls._initialized = False
        cls._node_number = 1
        cls._core_number = 1


def init_engine(*args, **kwargs):
    """pyspark parity: ``init_engine()`` (pyspark/bigdl/util/engine.py)."""
    return Engine.init(*args, **kwargs)
