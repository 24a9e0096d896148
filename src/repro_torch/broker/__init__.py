"""Log-based message broker (Kafka analog) — host-side data plane.

A copy of the JAX package's broker on the log plane only; it holds no
tensors and imports no torch.
"""
from repro_torch.broker.cluster import BrokerCluster, BrokerNode, Topic
from repro_torch.broker.consumer import Consumer, ConsumerGroup, Message
from repro_torch.broker.errors import BrokerError, BrokerTimeout, BrokerUnavailable
from repro_torch.broker.log import BackpressureError, PartitionLog
from repro_torch.broker.producer import Producer
from repro_torch.broker.records import Record, decode_array, decode_msg, encode_array, encode_msg

__all__ = [
    "BackpressureError",
    "BrokerCluster",
    "BrokerError",
    "BrokerNode",
    "BrokerTimeout",
    "BrokerUnavailable",
    "Consumer",
    "ConsumerGroup",
    "Message",
    "PartitionLog",
    "Producer",
    "Record",
    "Topic",
    "decode_array",
    "decode_msg",
    "encode_array",
    "encode_msg",
]
