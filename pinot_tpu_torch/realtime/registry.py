"""Stream factory/decoder registries + table-config → StreamConfig.

Parity: the reference instantiates StreamConsumerFactory and
StreamMessageDecoder by class name from the table's streamConfigs map
(StreamConfig.java / StreamConsumerFactoryProvider). Class-name reflection
becomes a process-local registry: connectors (or tests) register factory
instances under a name, and table configs reference them with
``stream.factory.name``.

The port's copy of pinot_tpu/realtime/registry.py; the built-in "tcp"
provider raises NotPorted until the port has the TCP connector.
"""
from __future__ import annotations

from typing import Dict, Optional

from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.realtime.stream import (JsonMessageDecoder, SMALLEST_OFFSET,
                                       StreamConfig, StreamConsumerFactory,
                                       StreamMessageDecoder)

_factories: Dict[str, StreamConsumerFactory] = {}
_decoders: Dict[str, type] = {"json": JsonMessageDecoder}


def register_stream_factory(name: str, factory: StreamConsumerFactory
                            ) -> None:
    _factories[name] = factory


def unregister_stream_factory(name: str) -> None:
    _factories.pop(name, None)


def _tcp_provider(stream_configs: Dict[str, str]) -> StreamConsumerFactory:
    """Built-in cross-process connector: the factory is constructed from
    the table config alone (stream.tcp.host/port), so a REMOTE server
    process needs no pre-registered in-process object — the property
    that makes realtime work across OS processes (parity: the Kafka
    connector's broker-list-in-config construction,
    KafkaPartitionLevelConsumer.java). The TCP connector
    (pinot_tpu/realtime/tcp_stream.py) is not in the port yet."""
    from pinot_tpu_torch.query.plan import NotPorted
    raise NotPorted("the TCP stream connector (realtime/tcp_stream.py) "
                    "comes with the LLC consumer")


# factory PROVIDERS build a factory from the streamConfigs map itself;
# instance registrations (register_stream_factory) take precedence
_providers = {"tcp": _tcp_provider}


def get_stream_factory(name: str, stream_configs: Optional[Dict[str, str]]
                       = None) -> StreamConsumerFactory:
    if name in _factories:
        return _factories[name]
    if name in _providers and stream_configs is not None:
        return _providers[name](stream_configs)
    raise KeyError(f"no stream factory registered under {name!r}")


def register_decoder(name: str, decoder_cls: type) -> None:
    _decoders[name] = decoder_cls


def resolve_stream_config(table_config: TableConfig) -> StreamConfig:
    """streamConfigs map → StreamConfig (factory/decoder resolved here).

    Recognized keys (parity: CommonConstants.Helix.DataSource.Realtime /
    realtime.segment.flush.*):
      stream.factory.name            registry key (required)
      stream.topic.name              topic (required)
      stream.decoder.name            decoder registry key (default "json")
      stream.offset.criteria         smallest|largest (default smallest)
      realtime.segment.flush.threshold.size     rows per segment
      realtime.segment.flush.threshold.time.ms  ms per segment
      stream.fetch.timeout.ms
    """
    sc = table_config.indexing_config.stream_configs or {}
    factory = get_stream_factory(sc["stream.factory.name"], sc)
    decoder_cls = _decoders[sc.get("stream.decoder.name", "json")]
    kw = {}
    if "realtime.segment.flush.threshold.size" in sc:
        kw["flush_threshold_rows"] = int(
            sc["realtime.segment.flush.threshold.size"])
    if "realtime.segment.flush.threshold.time.ms" in sc:
        kw["flush_threshold_time_ms"] = int(
            sc["realtime.segment.flush.threshold.time.ms"])
    if "stream.fetch.timeout.ms" in sc:
        kw["fetch_timeout_ms"] = int(sc["stream.fetch.timeout.ms"])
    return StreamConfig(
        topic=sc["stream.topic.name"],
        consumer_factory=factory,
        decoder=decoder_cls(),
        offset_criteria=sc.get("stream.offset.criteria", SMALLEST_OFFSET),
        **kw)
