"""Processing-engine plugins. Importing this package registers them all:
the broker (``kafka``), the micro-batch engine (``spark``), the continuous
engine (``flink``) and the task pool (``dask``)."""
from repro_torch.engines.broker_plugin import BrokerPlugin
from repro_torch.engines.continuous import ContinuousPlugin, ContinuousStream
from repro_torch.engines.microbatch import MicroBatchPlugin, MicroBatchStream
from repro_torch.engines.taskpool import TaskPoolPlugin

__all__ = [
    "BrokerPlugin",
    "ContinuousPlugin",
    "ContinuousStream",
    "MicroBatchPlugin",
    "MicroBatchStream",
    "TaskPoolPlugin",
]
