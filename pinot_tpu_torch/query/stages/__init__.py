"""Multi-stage query engine: joins, window functions, and the exchange
plane that ships columnar blocks between a stage-1 producer and a
stage-2 consumer.

Counterpart of pinot_tpu/query/stages/. Layout (submodules import
explicitly; this package init stays empty so that query/plan.py can
import stages.errors without cycles):

- errors.py    typed stage compile / execution errors
- exchange.py  ExchangeManager and the in-process fetch of published blocks
- join.py      JoinContext: dim-side blocks -> probe / gather tables
- window.py    stage-2 window executor (K12 + K13 on the card, numpy twin)
- broker.py    the stage-1 request builders (dim scan, window scan)

The broker's scatter and the TCP data plane are not in the port yet: a
join or window runs in process, stage 1 through ServerQueryExecutor,
its DataTable published with ExchangeManager.put, stage 2 through
join.build_context + ServerQueryExecutor (or ShardedQueryExecutor) or
window.execute_window_stage.
"""
