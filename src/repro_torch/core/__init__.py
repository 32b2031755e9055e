"""The port's own copy of the log and consumer-group layer that serving
uses (on-disk formats identical to ``repro.core``)."""
from .delivery import Consumer, ConsumerGroup, OffsetStore, StaleGeneration
from .log import CorruptRecord, PartitionedLog, route_partition
from .logstore import LogRecord

__all__ = ["Consumer", "ConsumerGroup", "CorruptRecord", "LogRecord",
           "OffsetStore", "PartitionedLog", "StaleGeneration",
           "route_partition"]
