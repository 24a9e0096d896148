"""Processing-engine plugins. Importing this package registers them all:
the broker (``kafka``) and the micro-batch engine (``spark``)."""
from repro_torch.engines.broker_plugin import BrokerPlugin
from repro_torch.engines.microbatch import MicroBatchPlugin, MicroBatchStream

__all__ = [
    "BrokerPlugin",
    "MicroBatchPlugin",
    "MicroBatchStream",
]
