"""The query server: data manager, schedulers, admission, result cache,
residency tiers and the TCP-serving instance (the counterpart of
pinot_tpu/server; http_api, participant and agent wait for the port's
HTTP transport and controller)."""
from pinot_tpu_torch.server.data_manager import (InstanceDataManager,
                                                 SegmentDataManager,
                                                 TableDataManager)
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.server.query_executor import InstanceQueryExecutor
from pinot_tpu_torch.server.scheduler import (FCFSQueryScheduler,
                                              TokenBucketScheduler,
                                              make_scheduler)

__all__ = ["InstanceDataManager", "SegmentDataManager", "TableDataManager",
           "ServerInstance", "InstanceQueryExecutor", "FCFSQueryScheduler",
           "TokenBucketScheduler", "make_scheduler"]
