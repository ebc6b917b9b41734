"""The port's functional spMTTKRP engine (see :mod:`.api`), its
out-of-core streaming tier (:mod:`.stream`), its distributed tier over a
mesh of shards (:mod:`.dist`: ``shard_state``, ``dist_mttkrp``,
``dist_all_modes``, the permute / all_gather remap exchange), and above
them the
plan-space entry points: :func:`make_engine` builds an engine from one
:class:`PlanSpec` through the plan cache, and :func:`autotune` picks a
spec from a :class:`PlanSpace`.

Observability (:mod:`repro_torch.obs`): spans ``factory.make_engine``,
``autotune``, ``autotune.analytic``, ``autotune.exact``,
``autotune.hill_climb``, ``autotune.measure``, ``plan.cache_lookup``, the
``engine.*``, ``stream.*`` and ``dist.*`` spans; gauge
``dist_exchange_bytes``, counter ``dist_copied_bytes``; counters
``engine_dispatches``
(per entry point), ``plan_cache_outcomes`` (hit / structural / miss /
disk_corrupt), ``stream_replan_outcomes``, ``stream_counts`` and
``stream_bytes``; gauge ``stream_peaks``.

Resilience (:mod:`repro_torch.resilience`): ``make_engine(ladder=)``
takes the ``full -> stream`` rung on an OOM, ``stream_mttkrp(policy=)``
the chunk-budget and backend rungs and upload retries, ``cp_als`` /
``cp_als_stream`` the backend rung, the NaN guard and checkpoints
(``BACKEND_LADDER``, on the card ``CARD_LADDER``, in :mod:`.config`);
every rung is a ``resilience_degradations`` / ``resilience_retries``
counter label and a ``resilience.*`` span, every injected fault a
``chaos_injections`` label. ``cp_als(mesh=)`` adds the distributed
rungs: ``permute -> all_gather`` on an exchange failure, a re-shard on
the surviving mesh on a device loss, retries of a transient dispatch.
"""
from .api import (DISPATCH_COUNTS, FoldFn, all_modes, init, mttkrp,
                  reset_counters)
from .autotune import (AutotuneResult, analytic_cost, autotune, hill_climb,
                       modeled_cost)
from .backends import BACKENDS, get_backend, register_backend
from .config import ExecutionConfig
from . import dist
from .dist import (DistConfig, DistState, ExchangeSchedule, dist_all_modes,
                   dist_mttkrp, shard_state, surviving_mesh)
from .factory import SPACE_DIMS, PlanSpace, PlanSpec, make_engine
from .state import EngineState, ModeSched, ModeStatic
from .stream import (StreamPlan, StreamState, StreamStats, cp_als_stream,
                     plan_stream, resident_bytes, stream_all_modes,
                     stream_init, stream_mttkrp, stream_transfer_model)

__all__ = ["init", "mttkrp", "all_modes", "reset_counters",
           "DISPATCH_COUNTS", "FoldFn", "BACKENDS", "get_backend",
           "register_backend", "ExecutionConfig",
           "EngineState", "ModeSched", "ModeStatic", "PlanSpec",
           "PlanSpace", "make_engine", "SPACE_DIMS", "autotune",
           "AutotuneResult", "analytic_cost", "modeled_cost",
           "hill_climb", "StreamPlan", "StreamState", "StreamStats",
           "plan_stream", "stream_init", "stream_mttkrp",
           "stream_all_modes", "cp_als_stream", "resident_bytes",
           "stream_transfer_model", "dist", "DistConfig", "DistState",
           "ExchangeSchedule", "shard_state", "dist_mttkrp",
           "dist_all_modes", "surviving_mesh"]
