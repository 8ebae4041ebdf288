"""`ai-chat-completions` / `ai-text-completions` steps.

Parity: reference `ChatCompletionsStep.java:42,115,137` and
`TextCompletionsStep.java` — prompt templates rendered per record, completion
via the resolved CompletionsService, streamed chunks written to
`stream-to-topic` with `stream-id`/`stream-index`/`stream-last-message`
properties BEFORE the final record commits (this is what gives the gateway
its TTFT), final answer into `completion-field`, request metadata into
`log-field`.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Optional

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.genai.steps import Step
from langstream_tpu_torch.ai.provider import ChatChunk, ChatMessage
from langstream_tpu_torch.tracing import TRACE_HEADER, TRACER

log = logging.getLogger(__name__)


def _set_result_field(record: MutableRecord, field: Optional[str], content: str) -> None:
    if field:
        record.set_field(field, content)
    else:
        record.value = content
        record._value_was_json = False


class _BaseCompletionsStep(Step):
    streaming_field_key = "stream-response-completion-field"

    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        self.model = config.get("model", "")
        self.completion_field = config.get("completion-field")
        self.log_field = config.get("log-field")
        self.stream_to_topic = config.get("stream-to-topic")
        self.stream_response_field = config.get(self.streaming_field_key)
        self.min_chunks = int(config.get("min-chunks-per-message", 20))
        self.ai_service = config.get("ai-service")
        self._producer = None
        self._service = None

    async def start(self, context: Any) -> None:
        registry = context.get_service_provider_registry()
        provider = registry.get_provider(self.ai_service)
        self._service = provider.get_completions_service(dict(self.config))
        if self.stream_to_topic:
            self._producer = context.get_topic_producer(self.stream_to_topic)
            await self._producer.start()
        # serving gauges (SURVEY §5: "same shape, plus tokens/sec, TTFT,
        # batch occupancy" — counters match the reference's
        # openai_*_num_calls_total naming scheme)
        # per-agent scope (multiple completions agents share one registry)
        metrics = context.get_metrics_reporter().with_prefix(
            f"agent_{context.get_global_agent_id()}_completions"
        )
        self._m_calls = metrics.counter("num_calls_total", "completion calls")
        self._m_tokens = metrics.counter("completion_tokens_total", "generated tokens")
        self._m_prompt = metrics.counter("prompt_tokens_total", "prompt tokens")
        self._m_ttft = metrics.gauge("last_ttft_ms", "last time-to-first-token")
        self._m_rate = metrics.gauge("last_tokens_per_sec", "last request decode rate")
        self._m_active = metrics.gauge("engine_active_slots", "busy KV-cache slots")
        self._m_queued = metrics.gauge("engine_queued_requests", "requests waiting for a slot")
        self._m_hbm = metrics.gauge(
            "engine_hbm_gbps", "achieved HBM read bandwidth per decode step"
        )
        self._m_step = metrics.gauge(
            "engine_decode_step_ms", "measured decode step time (EMA)"
        )
        self._m_programs = metrics.gauge(
            "engine_compiled_programs",
            "distinct device programs dispatched (growth after warmup = "
            "a mid-traffic XLA compile stall)",
        )
        # prefix KV reuse (serving/prefix_cache.py) — all sourced from the
        # engine's cumulative stats, so gauges (not counters) carry them
        self._m_prefix_hit = metrics.gauge(
            "engine_prefix_cache_hit_rate",
            "fraction of admissions that reused a cached prompt prefix",
        )
        self._m_prefix_saved = metrics.gauge(
            "engine_prefill_tokens_saved_total",
            "prompt tokens NOT re-prefilled thanks to prefix KV reuse "
            "(cumulative)",
        )
        self._m_prefix_bytes = metrics.gauge(
            "engine_prefix_pool_bytes_in_use",
            "device HBM held by live prefix-cache entries",
        )
        self._m_prefix_evict = metrics.gauge(
            "engine_prefix_cache_evictions_total",
            "prefix-cache LRU evictions (cumulative)",
        )
        # self-speculative decoding (serving/engine.py _verify_chunk):
        # engine-cumulative ratios, so gauges carry them like the prefix set
        self._m_spec_accept = metrics.gauge(
            "engine_spec_acceptance_rate",
            "fraction of proposed draft tokens the model accepted "
            "(speculative decoding; 0 when off)",
        )
        self._m_spec_per_step = metrics.gauge(
            "engine_spec_accepted_tokens_per_step",
            "tokens emitted per verify dispatch (each dispatch = ONE weight "
            "read; 1.0 means speculation is buying nothing)",
        )
        self._m_spec_hit = metrics.gauge(
            "engine_spec_draft_hit_rate",
            "fraction of draft lookups where the n-gram index had a proposal",
        )
        # unified paged KV pool (serving/pagepool.py): live pool pressure,
        # aliasing effectiveness, and the copy traffic aliasing eliminated
        self._m_kv_pages = metrics.gauge(
            "engine_kv_pages_in_use",
            "physical KV pages currently allocated (paged layout; 0 dense)",
        )
        self._m_kv_alias = metrics.gauge(
            "engine_kv_page_alias_rate",
            "fraction of reserved KV pages satisfied by prefix aliasing "
            "instead of fresh allocation (cumulative; 0 when dense)",
        )
        self._m_prefix_copy_saved = metrics.gauge(
            "engine_prefix_copy_bytes_saved_total",
            "bytes of KV copy eliminated by page aliasing vs the dense "
            "gather-per-hit design (cumulative)",
        )
        # tiered KV: host-RAM spill + session hibernation (serving/
        # pagepool.HostPageTier, docs/SERVING.md §16) — arena occupancy,
        # spill/restore byte traffic, and the restore-vs-recompute split
        self._m_host_pages_total = metrics.gauge(
            "engine_host_pages_total",
            "host-tier KV arena capacity in pages (0 with the tier off)",
        )
        self._m_host_pages = metrics.gauge(
            "engine_host_pages_in_use",
            "host-tier arena pages holding hibernated prefix KV",
        )
        self._m_spill_bytes = metrics.gauge(
            "engine_spill_bytes_total",
            "KV bytes spilled device→host (hibernation), cumulative",
        )
        self._m_restore_bytes = metrics.gauge(
            "engine_restore_bytes_total",
            "KV bytes restored host→device (session wake), cumulative",
        )
        self._m_restored_hits = metrics.gauge(
            "engine_restored_hits_total",
            "warm admissions served by a host-tier restore instead of a "
            "re-prefill, cumulative",
        )
        self._m_recompute_fallbacks = metrics.gauge(
            "engine_recompute_fallbacks_total",
            "host-tier hits that fell back to recompute (failed/corrupt/"
            "no-room restore), cumulative",
        )
        # request lifecycle / fault recovery (serving/engine.py): sourced
        # from the engine's cumulative stats, gauges like the prefix set
        self._m_shed = metrics.gauge(
            "engine_shed_total",
            "requests shed at admission (full queue / hopeless deadline / "
            "draining), cumulative",
        )
        self._m_deadline = metrics.gauge(
            "engine_deadline_exceeded_total",
            "requests past their deadline (in queue or mid-decode), cumulative",
        )
        self._m_cancelled = metrics.gauge(
            "engine_cancelled_total",
            "requests cancelled (client disconnect / timeout), cumulative",
        )
        self._m_quarantined = metrics.gauge(
            "engine_quarantined_slots_total",
            "slots failed by device faults or the NaN-logits guard, cumulative",
        )
        self._m_restarts = metrics.gauge(
            "engine_restarts_total",
            "engine-loop restarts after a crash (bounded-backoff recovery), "
            "cumulative",
        )
        # SPMD slice resilience (parallel/spmd_serving.py, docs/SERVING.md
        # §20): coordinated recover-in-place epochs, divergence resyncs
        # and watchdog escalations — zeros single-host, gauges like the
        # lifecycle set above
        self._m_spmd_recoveries = metrics.gauge(
            "engine_spmd_recoveries_total",
            "coordinated SPMD recoveries (leader crash -> OP_RECOVER, both "
            "sides rebuilt in place, zero process exits), cumulative",
        )
        self._m_spmd_epoch = metrics.gauge(
            "engine_spmd_recovery_epoch",
            "current SPMD recovery epoch (bumped per coordinated recovery "
            "or divergence resync; 0 = never recovered)",
        )
        self._m_spmd_resyncs = metrics.gauge(
            "engine_spmd_resyncs_total",
            "coordinated divergence resyncs granted (OP_RESYNC answered a "
            "follower's echo-mismatch/seq-gap report), cumulative",
        )
        self._m_spmd_watchdog = metrics.gauge(
            "engine_spmd_watchdog_trips_total",
            "leader-side watchdog escalations (a wedged iteration's fetch "
            "exceeded spmd-watchdog-s and forced OP_RECOVER), cumulative",
        )
        # the agentic serving tier (serving/adapters.py + constrain.py,
        # docs/SERVING.md §15): adapter residency/swap pressure and the
        # constrained-decoding volume + host-side mask overhead
        self._m_adapters_resident = metrics.gauge(
            "engine_adapters_resident",
            "LoRA adapters currently resident in the device pool",
        )
        self._m_adapter_swaps = metrics.gauge(
            "engine_adapter_swaps_total",
            "adapter hot-swaps onto the device (LRU residency misses), "
            "cumulative — sustained growth means the pool is too small",
        )
        self._m_constrained = metrics.gauge(
            "engine_constrained_requests_total",
            "requests decoded under a response_format grammar, cumulative",
        )
        self._m_constrain_overhead = metrics.gauge(
            "engine_constrain_overhead_ms",
            "host-side constrained-decoding bookkeeping per dispatch "
            "(grammar swaps + verify state tables), EMA ms",
        )
        self._m_grammar_pool_bytes = metrics.gauge(
            "engine_grammar_pool_bytes",
            "HBM held by the packed grammar pool (bitmask + default/"
            "exception planes across all slots), bytes",
        )
        self._m_grammar_rows = metrics.gauge(
            "engine_grammar_rows_resident",
            "grammars currently resident in the device pool (swap "
            "pressure shows in engine_grammar_swaps via stats)",
        )
        # multi-tenant overload control (serving/tenancy.py, docs/
        # SERVING.md §19): cross-tenant shed volume, the worst tenant's
        # queue-wait EMA (the noisy-neighbor victim signal — per-tenant
        # detail lives in stats()["tenants"] and the fleet beacons), and
        # the brownout ladder level
        self._m_tenant_shed = metrics.gauge(
            "tenant_shed_total",
            "requests shed across ALL tenants (quota, queue share, "
            "brownout, overload), cumulative — per-tenant split in "
            "engine stats and beacons",
        )
        self._m_tenant_wait = metrics.gauge(
            "tenant_queue_wait",
            "WORST per-tenant queue-wait EMA (s) — the noisy-neighbor "
            "victim signal; flat while the aggregate climbs means "
            "isolation is holding",
        )
        self._m_brownout_level = metrics.gauge(
            "brownout_level",
            "brownout degradation-ladder level (0 normal, 1 spec-shrink, "
            "2 spec-off, 3 reject-low, 4 reject-quota)",
        )
        self._m_brownout_transitions = metrics.gauge(
            "brownout_transitions_total",
            "brownout ladder transitions (either direction), cumulative",
        )
        # observability layer (serving/observability.py, docs/SERVING.md
        # §12): the engine-derived load score the replica balancer routes
        # on, the flight-recorder dump counter, and the full streaming-
        # latency histogram set. The engine owns the live histograms; the
        # exporter MIRRORS their snapshots into the Prometheus registry so
        # /metrics carries real _bucket/_sum/_count series (the Grafana
        # TTFT heatmap reads them).
        self._m_load = metrics.gauge(
            "engine_load_score",
            "queue-wait p90 (s) + slot occupancy + page-pool pressure — "
            "relative load signal for cache-aware replica balancing",
        )
        self._m_flight_dumps = metrics.gauge(
            "engine_flight_dumps_total",
            "flight-recorder postmortem dumps produced (quarantines, "
            "restarts, shed bursts, on-demand), cumulative",
        )
        # fleet routing tier (serving/fleet.py, docs/SERVING.md §13):
        # router-cumulative counters carried as gauges like the engine
        # sets; zeros while fleet: off so the exporter is unconditional
        self._m_fleet_affinity = metrics.gauge(
            "fleet_routed_affinity_total",
            "requests routed by prefix affinity (incl. sticky sessions) — "
            "the cache-aware hits, cumulative",
        )
        self._m_fleet_balanced = metrics.gauge(
            "fleet_routed_balanced_total",
            "requests routed by load only (no usable prefix anywhere), "
            "cumulative",
        )
        self._m_fleet_replicas = metrics.gauge(
            "fleet_replica_count",
            "replicas the fleet router fronts (routable or not)",
        )
        # fleet wire hardening (docs/SERVING.md §17): mid-stream warm
        # failovers, the per-replica circuit breaker, beacon probe health,
        # and the remote-hop latency histogram (mirrored from the router
        # the same way the engine histograms are)
        self._m_fleet_stream_failovers = metrics.gauge(
            "fleet_stream_failovers_total",
            "mid-STREAM warm failovers — a replica died after delivering "
            "tokens and the router resumed on a survivor, cumulative",
        )
        self._m_fleet_circuit_open = metrics.gauge(
            "fleet_circuit_open_total",
            "per-replica circuit-breaker OPEN transitions (consecutive "
            "beacon/dispatch failures past the threshold), cumulative",
        )
        self._m_fleet_beacon_failures = metrics.gauge(
            "fleet_beacon_failures_total",
            "beacon (/state) fetch failures across the fleet — sustained "
            "growth on one replica means its probe is in backoff, "
            "cumulative",
        )
        # disaggregated prefill/decode (serving/migrate.py + fleet.py,
        # docs/SERVING.md §18): KV-page migration traffic and the
        # decode-in-place fallback counter — a rising fallback share
        # means the migration wire (or the decode pool) is unhealthy
        self._m_fleet_migrations = metrics.gauge(
            "fleet_migrations_total",
            "completed KV-page migrations (receiver-ACKed, sender "
            "released), cumulative",
        )
        self._m_fleet_migrate_pages = metrics.gauge(
            "fleet_pages_migrated_total",
            "KV pages moved between replicas by completed migrations, "
            "cumulative",
        )
        self._m_fleet_migrate_bytes = metrics.gauge(
            "fleet_migrate_bytes_total",
            "bytes moved between replicas by completed migrations "
            "(int8 pools ship half the bf16 bytes), cumulative",
        )
        self._m_fleet_migrate_fallbacks = metrics.gauge(
            "fleet_migrate_fallbacks_total",
            "migrations that failed (checksum, cut, deadline, exhaustion) "
            "and fell back to decode-in-place, cumulative",
        )
        # binary fleet wire v2 + P2P page fetch (docs/SERVING.md §21):
        # bytes on the replica-to-replica wire by protocol (the v1-vs-v2
        # overhead pair), and the radix-miss fetch outcomes — a rising
        # fallback share means the P2P wire (or the owners' arenas) is
        # unhealthy while requests silently re-prefill cold
        self._m_fleet_wire_bytes = {
            proto: metrics.gauge(
                "fleet_wire_bytes_total",
                "bytes written to the replica-to-replica fleet wire by "
                "protocol (v1 NDJSON vs v2 binary), sender-side, "
                "cumulative",
                labels={"proto": proto},
            )
            for proto in ("v1", "v2")
        }
        self._m_fleet_p2p_fetch = metrics.gauge(
            "fleet_p2p_fetch_total",
            "peer-to-peer page fetches that bound warm on a radix miss "
            "(owner kept its copy), cumulative",
        )
        self._m_fleet_p2p_fallback = metrics.gauge(
            "fleet_p2p_fetch_fallback_total",
            "peer-to-peer page fetches that failed (checksum, net-cut, "
            "deadline, no capable peer) and re-prefilled locally, "
            "cumulative",
        )
        self._m_fleet_p2p_bytes_in = metrics.gauge(
            "fleet_p2p_bytes_in_total",
            "page bytes admitted from peers by completed P2P fetches "
            "(receiver-ACKed), cumulative",
        )
        # durable session tier (serving/durable.py, docs/SERVING.md §23):
        # disk checkpoint/restore volume plus the two failure modes an
        # operator alerts on — restore failures (rot, torn writes) and
        # dead entries (checkpoints discarded as unreadable). All
        # engine-cumulative, gauges like the spill set above.
        self._m_durable_entries = metrics.gauge(
            "durable_entries",
            "session checkpoints resident in the durable tier's on-disk "
            "index right now",
        )
        self._m_durable_bytes = metrics.gauge(
            "durable_bytes_on_disk",
            "bytes the durable tier currently holds on disk (frame "
            "streams + manifests)",
        )
        self._m_durable_checkpoints = metrics.gauge(
            "durable_checkpoints_total",
            "session checkpoints durably committed (temp+fsync+rename "
            "landed), cumulative",
        )
        self._m_durable_ckpt_bytes = metrics.gauge(
            "durable_checkpoint_bytes_total",
            "bytes durably committed by session checkpoints, cumulative",
        )
        self._m_durable_restores = metrics.gauge(
            "durable_restores_total",
            "sessions resurrected from the durable tier (disk → device "
            "bind verified), cumulative",
        )
        self._m_durable_restore_bytes = metrics.gauge(
            "durable_restore_bytes_total",
            "bytes read back by durable-tier restores, cumulative",
        )
        self._m_durable_restore_failures = metrics.gauge(
            "durable_restore_failures_total",
            "durable restores that failed (torn frame, checksum "
            "mismatch, stall, dead entry) and degraded to local cold "
            "prefill, cumulative",
        )
        self._m_durable_dead = metrics.gauge(
            "durable_dead_entries_total",
            "checkpoints discarded as unreadable (torn write, rot, "
            "missing manifest), cumulative",
        )
        # prefetch-on-hint (§23): beacon-driven warm fetches issued ahead
        # of request routing, router-cumulative like the P2P set
        self._m_fleet_prefetch = metrics.gauge(
            "fleet_prefetch_total",
            "prefetch hints accepted by the router (beacon said a deeper "
            "owner exists), cumulative",
        )
        self._m_fleet_prefetch_fetch = metrics.gauge(
            "fleet_prefetch_fetch_total",
            "prefetch hints that completed a P2P/durable page fetch "
            "before the request routed, cumulative",
        )
        self._m_fleet_cost_routed = metrics.gauge(
            "fleet_p2p_cost_routed_total",
            "P2P fetch decisions made by the bytes-vs-prefill cost model "
            "(rather than the flat threshold floor), cumulative",
        )
        self._m_weight_load_s = metrics.gauge(
            "weight_load_s",
            "checkpoint→device weight load wall time for this engine "
            "build (read + transform + transfer, s); the cold-start drill "
            "compares streamed vs eager on this gauge",
        )
        self._m_weight_load_bytes = metrics.gauge(
            "weight_load_bytes_total",
            "checkpoint bytes read by the engine weight load (streamed: "
            "summed tensor spans; eager: materialized tree bytes)",
        )
        from langstream_tpu_torch.serving.observability import (
            ENGINE_HISTOGRAMS,
            FLEET_HISTOGRAMS,
        )

        self._m_hists = {
            name: metrics.histogram(name, spec["help"], spec["buckets"])
            for name, spec in ENGINE_HISTOGRAMS.items()
        }
        self._m_fleet_hists = {
            name: metrics.histogram(name, spec["help"], spec["buckets"])
            for name, spec in FLEET_HISTOGRAMS.items()
        }

    def _record_metrics(self, result: Any) -> None:
        self._m_calls.count()
        self._m_tokens.count(result.completion_tokens)
        self._m_prompt.count(result.prompt_tokens)
        ttft_ms = result.ttft_ms or 0.0
        if ttft_ms:
            self._m_ttft.set(round(ttft_ms, 3))
        decode_s = max((result.total_ms or 0.0) - ttft_ms, 0.0) / 1000.0
        if decode_s > 0 and result.completion_tokens:
            self._m_rate.set(round(result.completion_tokens / decode_s, 2))
        # batch occupancy (SURVEY §5): engine-backed services report slots
        stats = getattr(self._service, "engine_stats", lambda: None)() or {}
        # always set: stale occupancy must decay to 0, not freeze
        self._m_active.set(stats.get("active-slots", 0))
        self._m_queued.set(stats.get("queued", 0))
        self._m_hbm.set(stats.get("hbm-gbps-decode", 0))
        self._m_step.set(stats.get("decode-step-ms", 0))
        self._m_programs.set(stats.get("compiled_programs", 0))
        self._m_prefix_hit.set(stats.get("prefix-cache-hit-rate", 0))
        self._m_prefix_saved.set(stats.get("prefill-tokens-saved-total", 0))
        self._m_prefix_bytes.set(stats.get("prefix-pool-bytes-in-use", 0))
        self._m_prefix_evict.set(stats.get("prefix-cache-evictions-total", 0))
        self._m_spec_accept.set(stats.get("spec-acceptance-rate", 0))
        self._m_spec_per_step.set(stats.get("spec-accepted-tokens-per-step", 0))
        self._m_spec_hit.set(stats.get("spec-draft-hit-rate", 0))
        self._m_kv_pages.set(stats.get("kv-pages-in-use", 0))
        self._m_kv_alias.set(stats.get("kv-page-alias-rate", 0))
        self._m_prefix_copy_saved.set(stats.get("prefix-copy-bytes-saved-total", 0))
        self._m_host_pages_total.set(stats.get("host-pages-total", 0))
        self._m_host_pages.set(stats.get("host-pages-in-use", 0))
        self._m_spill_bytes.set(stats.get("spill-bytes-total", 0))
        self._m_restore_bytes.set(stats.get("restore-bytes-total", 0))
        self._m_restored_hits.set(stats.get("restored-hits-total", 0))
        self._m_recompute_fallbacks.set(stats.get("recompute-fallbacks-total", 0))
        self._m_shed.set(stats.get("shed-total", 0))
        self._m_deadline.set(stats.get("deadline-exceeded-total", 0))
        self._m_cancelled.set(stats.get("cancelled-total", 0))
        self._m_quarantined.set(stats.get("quarantined-slots-total", 0))
        self._m_restarts.set(stats.get("engine-restarts-total", 0))
        self._m_spmd_recoveries.set(stats.get("spmd-recoveries-total", 0))
        self._m_spmd_epoch.set(stats.get("spmd-recovery-epoch", 0))
        self._m_spmd_resyncs.set(stats.get("spmd-resyncs-total", 0))
        self._m_spmd_watchdog.set(stats.get("spmd-watchdog-trips-total", 0))
        self._m_adapters_resident.set(stats.get("adapters-resident", 0))
        self._m_adapter_swaps.set(stats.get("adapter-swaps-total", 0))
        self._m_constrained.set(stats.get("constrained-requests-total", 0))
        self._m_constrain_overhead.set(stats.get("constrain-overhead-ms", 0))
        self._m_grammar_pool_bytes.set(stats.get("grammar-pool-bytes", 0))
        self._m_grammar_rows.set(stats.get("grammars-resident", 0))
        tenants = stats.get("tenants") or {}
        self._m_tenant_shed.set(
            sum(int(t.get("shed-total", 0)) for t in tenants.values())
        )
        self._m_tenant_wait.set(
            max(
                (
                    float(t.get("queue-wait-ema-s", 0.0))
                    for t in tenants.values()
                ),
                default=0.0,
            )
        )
        self._m_brownout_level.set(stats.get("brownout-level", 0))
        self._m_brownout_transitions.set(
            stats.get("brownout-transitions-total", 0)
        )
        self._m_load.set(stats.get("load-score", 0))
        self._m_flight_dumps.set(stats.get("flight-dumps-total", 0))
        self._m_weight_load_s.set(stats.get("weight-load-s", 0))
        self._m_weight_load_bytes.set(stats.get("weight-load-bytes-total", 0))
        self._m_durable_entries.set(stats.get("durable-entries", 0))
        self._m_durable_bytes.set(stats.get("durable-bytes-on-disk", 0))
        self._m_durable_checkpoints.set(
            stats.get("durable-checkpoints-total", 0)
        )
        self._m_durable_ckpt_bytes.set(
            stats.get("durable-checkpoint-bytes-total", 0)
        )
        self._m_durable_restores.set(stats.get("durable-restores-total", 0))
        self._m_durable_restore_bytes.set(
            stats.get("durable-restore-bytes-total", 0)
        )
        self._m_durable_restore_failures.set(
            stats.get("durable-restore-failures-total", 0)
        )
        self._m_durable_dead.set(stats.get("durable-dead-entries-total", 0))
        fleet = getattr(self._service, "fleet_stats", lambda: None)() or {}
        self._m_fleet_affinity.set(
            fleet.get("fleet-routed-affinity-total", 0)
            + fleet.get("fleet-routed-sticky-total", 0)
        )
        self._m_fleet_balanced.set(fleet.get("fleet-routed-balanced-total", 0))
        self._m_fleet_replicas.set(fleet.get("fleet-replica-count", 0))
        self._m_fleet_stream_failovers.set(
            fleet.get("fleet-stream-failovers-total", 0)
        )
        self._m_fleet_circuit_open.set(fleet.get("fleet-circuit-open-total", 0))
        self._m_fleet_beacon_failures.set(
            fleet.get("fleet-beacon-failures-total", 0)
        )
        self._m_fleet_migrations.set(fleet.get("fleet-migrations-total", 0))
        self._m_fleet_migrate_pages.set(
            fleet.get("fleet-migrate-pages-total", 0)
        )
        self._m_fleet_migrate_bytes.set(
            fleet.get("fleet-migrate-bytes-total", 0)
        )
        self._m_fleet_migrate_fallbacks.set(
            fleet.get("fleet-migrate-fallbacks-total", 0)
        )
        self._m_fleet_wire_bytes["v1"].set(
            fleet.get("fleet-wire-bytes-v1-total", 0)
        )
        self._m_fleet_wire_bytes["v2"].set(
            fleet.get("fleet-wire-bytes-v2-total", 0)
        )
        self._m_fleet_p2p_fetch.set(fleet.get("fleet-p2p-fetch-total", 0))
        self._m_fleet_p2p_fallback.set(
            fleet.get("fleet-p2p-fetch-fallback-total", 0)
        )
        self._m_fleet_p2p_bytes_in.set(
            fleet.get("fleet-p2p-bytes-in-total", 0)
        )
        self._m_fleet_prefetch.set(fleet.get("fleet-prefetch-total", 0))
        self._m_fleet_prefetch_fetch.set(
            fleet.get("fleet-prefetch-fetch-total", 0)
        )
        self._m_fleet_cost_routed.set(
            fleet.get("fleet-p2p-cost-routed-total", 0)
        )
        for name, snap in (stats.get("histograms") or {}).items():
            mirror = self._m_hists.get(name)
            if mirror is not None:
                try:
                    mirror.load(snap)
                except ValueError:  # bucket-spec drift — skip, don't crash
                    pass
        for name, snap in (fleet.get("histograms") or {}).items():
            mirror = self._m_fleet_hists.get(name)
            if mirror is not None:
                try:
                    mirror.load(snap)
                except ValueError:  # bucket-spec drift — skip, don't crash
                    pass

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()
            self._producer = None

    def _options(self) -> dict[str, Any]:
        opts = {
            k: self.config[k]
            for k in (
                "max-tokens", "temperature", "top-p", "top-k", "stop",
                "logit-bias", "user", "presence-penalty", "frequency-penalty",
                "options", "deadline", "max-queue-wait",
                # the agentic tier (docs/SERVING.md §15): per-request
                # adapter selection + structured-output grammar — these
                # MUST be forwarded or the documented knobs are dead code
                # (the round-8 whitelist lesson)
                "adapter", "response-format",
                # multi-tenant overload control (docs/SERVING.md §19):
                # the tenant/priority/cost-budget policy inputs — the
                # per-record tenant header overrides `tenant` in process()
                "tenant", "priority", "max-cost-tokens",
            )
            if self.config.get(k) is not None
        }
        opts["model"] = self.model
        opts["min-chunks-per-message"] = self.min_chunks
        return opts

    def _chunk_writer(
        self, record: MutableRecord, loop, futures: list,
        trace_id: Optional[str] = None,
    ) -> Any:
        """Returns a chunks_consumer that writes each chunk as its own record
        to the stream topic. May be invoked from the engine thread → schedule
        onto the agent event loop; the write futures are collected so
        process() can await them (chunks must not be silently lost)."""
        import asyncio

        step = self

        def consume(chunk: ChatChunk) -> None:
            copy = MutableRecord(
                key=record.key,
                value=record.value,
                properties=dict(record.properties),
                origin=record.origin,
                timestamp=record.timestamp,
                _key_was_json=record._key_was_json,
                _value_was_json=record._value_was_json,
            )
            copy.properties["stream-id"] = chunk.answer_id
            copy.properties["stream-index"] = str(chunk.index)
            copy.properties["stream-last-message"] = str(chunk.last).lower()
            if trace_id:
                # echo the trace id on every streamed chunk EXPLICITLY:
                # this callback runs on the engine thread, outside the
                # agent span context, so the producer's contextvars-based
                # stamping cannot reach it — without this the client-side
                # and engine-side traces never join (docs/SERVING.md §12)
                copy.properties.setdefault(TRACE_HEADER, trace_id)
            _set_result_field(copy, step.stream_response_field, chunk.content)
            out = copy.to_record()
            if step._producer is not None:
                futures.append(
                    asyncio.run_coroutine_threadsafe(step._producer.write(out), loop)
                )

        return consume

    async def process(self, record: MutableRecord, context: Any) -> None:
        import asyncio

        assert self._service is not None, "step not started"
        options = self._options()
        # client-disconnect cancellation: hand the record's chat session id
        # to the service so the gateway's ClientDisconnected handler can
        # cancel the in-flight generation (serving/lifecycle.py; only the
        # tpu-serving provider acts on it, remote providers ignore it)
        from langstream_tpu_torch.serving.lifecycle import SESSION_HEADER
        from langstream_tpu_torch.serving.tenancy import TENANT_HEADER

        session_id = record.properties.get(SESSION_HEADER)
        if session_id:
            options["cancel-key"] = str(session_id)
        # multi-tenant overload control (docs/SERVING.md §19): the record's
        # gateway-stamped tenant header is the per-request truth — it wins
        # over any static `tenant` in the step config (the gateway already
        # resolved client-header-vs-path precedence at the front door)
        record_tenant = record.properties.get(TENANT_HEADER)
        if record_tenant:
            options["tenant"] = str(record_tenant)
        # trace propagation: the record's gateway-stamped ls-trace-id (or
        # the agent span the runner opened for this batch) rides into the
        # GenerationRequest AND back out on every streamed chunk, so the
        # gateway→engine→fetch path stitches into ONE trace on /traces
        trace_id = record.properties.get(TRACE_HEADER) or TRACER.current_trace_id()
        if trace_id:
            options["trace-id"] = str(trace_id)
        chunks_consumer = None
        chunk_futures: list = []
        if self.stream_to_topic:
            chunks_consumer = self._chunk_writer(
                record, asyncio.get_running_loop(), chunk_futures,
                trace_id=str(trace_id) if trace_id else None,
            )
        try:
            result = await self._complete(record, options, chunks_consumer)
        except RuntimeError as shed:
            # quota/overload shed (engine ShedError / mapped fleet shed:
            # any RuntimeError carrying retry_after_s). On a SERVICE
            # gateway request/reply roundtrip, answer the caller with a
            # shed REPLY record instead of erroring the pipeline — the
            # gateway maps the properties to HTTP 429 + Retry-After
            # (docs/SERVING.md §19). Topic-driven flows keep the raise:
            # their errors policy (retry/dead-letter) owns the outcome.
            from langstream_tpu_torch.serving.tenancy import (
                RETRY_AFTER_PROPERTY,
                SERVICE_REQUEST_ID_PROPERTY,
                SHED_PROPERTY,
            )

            retry_after = getattr(shed, "retry_after_s", None)
            if (
                retry_after is None
                or not record.properties.get(SERVICE_REQUEST_ID_PROPERTY)
            ):
                raise
            record.properties[SHED_PROPERTY] = "true"
            record.properties[RETRY_AFTER_PROPERTY] = (
                f"{max(float(retry_after), 0.05):.3f}"
            )
            _set_result_field(record, self.completion_field, "")
            return
        self._record_metrics(result)
        # one line a request, on the runner task (a follower of the app's
        # logs sees it tagged with this agent's replica)
        log.info("completion %s: %d prompt + %d completion tokens, %s",
                 session_id or "-", result.prompt_tokens, result.completion_tokens,
                 result.finish_reason)
        if chunk_futures:
            # all chunks reach the stream topic before the final record commits
            await asyncio.gather(*(asyncio.wrap_future(f) for f in chunk_futures))
        _set_result_field(record, self.completion_field, result.content)
        if self.log_field:
            record.set_field(
                self.log_field,
                json.dumps({"model": self.model, "options": {k: v for k, v in options.items() if k != "options"}, "messages": self._log_messages(record)}),
            )

    # subclass hooks -------------------------------------------------------

    async def _complete(self, record, options, chunks_consumer):
        raise NotImplementedError

    def _log_messages(self, record: MutableRecord) -> Any:
        raise NotImplementedError


class ChatCompletionsStep(_BaseCompletionsStep):
    def _messages(self, record: MutableRecord) -> list[ChatMessage]:
        return [
            ChatMessage(
                role=m.get("role", "user"),
                content=el.render_template(m.get("content", ""), record),
            )
            for m in self.config.get("messages", [])
        ]

    async def _complete(self, record, options, chunks_consumer):
        return await self._service.get_chat_completions(
            self._messages(record), options, chunks_consumer
        )

    def _log_messages(self, record: MutableRecord) -> Any:
        return [{"role": m.role, "content": m.content} for m in self._messages(record)]


class TextCompletionsStep(_BaseCompletionsStep):
    streaming_field_key = "stream-response-completion-field"

    def _prompts(self, record: MutableRecord) -> list[str]:
        return [el.render_template(p, record) for p in self.config.get("prompt", [])]

    async def _complete(self, record, options, chunks_consumer):
        return await self._service.get_text_completions(
            self._prompts(record), options, chunks_consumer
        )

    def _log_messages(self, record: MutableRecord) -> Any:
        return self._prompts(record)
