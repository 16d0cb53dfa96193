"""Global configuration: the fields this package reads.

A reduced copy of ``futuresdr_tpu/config.py``: defaults, then a
``FUTURESDR_TPU_<FIELD>`` environment variable per field (the reference's
env layer; its TOML layers are not carried over), parsed by the field's
type, e.g. ``FUTURESDR_TPU_TPU_FRAMES_PER_DISPATCH=4``,
``FUTURESDR_TPU_TPU_WIRE_FORMAT=sc8``, ``FUTURESDR_TPU_XFER_BACKOFF=0.001``,
``FUTURESDR_TPU_CTRLPORT_ENABLE=true``,
``FUTURESDR_TPU_CTRLPORT_BIND=127.0.0.1:0``,
``FUTURESDR_TPU_FRONTEND_PATH=/path/to/gui``,
``FUTURESDR_TPU_BLOCK_POLICY=restart``, ``FUTURESDR_TPU_INTERIOR_PRECISION=auto``,
``FUTURESDR_TPU_SERVE_BUCKETS=1,4,16``
or ``FUTURESDR_TPU_AUTOTUNE_CACHE_DIR=/path``. A ``tpu_`` field also reads the
reference's short form without the field's ``tpu_`` head, e.g.
``FUTURESDR_TPU_WIRE_FORMAT=sc16`` (the full name wins where both are set).
A ``FUTURESDR_TPU_<NAME>`` variable that names no field lands in the
free-form ``misc`` map under ``<name>``, which :meth:`Config.get` reads.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field, fields
from typing import Any, Optional

__all__ = ["Config", "config", "reload_config"]

_ENV_PREFIX = "FUTURESDR_TPU_"


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _parse(name: str, default, raw: str):
    """``raw`` as the type of the field's default."""
    if isinstance(default, bool):
        v = raw.strip().lower()
        if v not in _TRUE + _FALSE:
            raise ValueError(f"{_ENV_PREFIX}{name.upper()}={raw!r} is not a boolean")
        return v in _TRUE
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclass
class Config:
    queue_size: int = 8192                 # message inbox capacity (try_send
    #   drops past it, send_async waits for room)
    buffer_size: int = 262144              # stream buffer size in bytes
    slab_reserved: int = 128               # reserved history items for slab
    #   buffers (informational: no buffer of the port reads it, nor of the
    #   reference)
    stack_size: int = 16 * 1024 * 1024     # (informational; Python threads
    #   use the default)
    log_level: str = "info"                # the package loggers' level
    #   (log.py init); FUTURESDR_TPU_LOG wins over it
    default_scheduler: str = "async"       # Runtime()'s scheduler: "async" | "threaded"
    ctrlport_enable: bool = False          # Runtime() starts the REST control port
    ctrlport_bind: str = "127.0.0.1:1337"  # its address; port 0 takes a free port
    frontend_path: str = ""                # the GUI directory the control port
    #   serves at / and /static/ ("" = the package's own gui/)
    tpu_frame_size: int = 1 << 18          # samples per device frame
    tpu_frames_in_flight: int = 4          # dispatch groups staged or computing at once
    tpu_frames_per_dispatch: int = 0       # megabatch K: frames run through one
    #   compiled replay per dispatch (per-dispatch host cost paid once per K
    #   frames); 0 = 1, or a fused region's cached autotune_streamed pick
    #   (runtime/devchain.py)
    tpu_inflight: int = 0                  # in-flight credit budget: 0 = an
    #   adaptive credit controller (tpu/kernel_block.py CreditController)
    #   seeded from tpu_frames_in_flight; N > 0 pins the budget (as does an
    #   explicit per-kernel frames_in_flight)
    host_arena: int = 1                    # recycled pinned staging buffers
    #   (ops/arena.py); 0 = a fresh pinned buffer per transfer
    host_arena_mb: int = 256               # arena pool byte cap: past it a
    #   released buffer is dropped to the allocator instead of pooled
    host_codec_workers: int = 2            # codec threads a lane (encode,
    #   decode; ops/codec_pool.py); 0 = the codec runs inline on the block
    # the uplink plane (ops/wire.py, ops/xfer.py, ops/ingest.py)
    tpu_wire_format: str = "auto"          # host <-> device wire codec:
    #   "auto" | "f32" | "bf16" | "sc16" | "sc8"; auto is f32 on the CPU and
    #   sc16 on a card (ops/wire.py resolve_wire)
    tpu_coalesce: bool = True              # pack a dispatch group's wire parts
    #   (payload + scale, K-stacked) into one buffer and one H2D, unpacked
    #   inside the program's graph (ops/xfer.py PackedLayout); false = one
    #   H2D a part
    tpu_zero_copy_ingest: bool = True      # frames of a registered read-only
    #   buffer (ops/ingest.py) skip the ring-exit copy on aliasing wires
    tpu_deferred_consume: bool = True      # quantizing wires at K = 1 with the
    #   codec pool: a worker encodes the ring slot in place and consume()
    #   waits for that read; false = encode inline before consume()
    tpu_adaptive_wire: bool = False        # mid-stream wire switching by the
    #   WireController (tpu/kernel_block.py); off: the wire is part of the
    #   numerics contract
    tpu_wire_snr_budget_db: float = 40.0   # the adaptive wire's SNR floor: the
    #   active format widens below it, a narrower one needs it plus a margin
    xfer_retries: int = 3                  # transient H2D/D2H retries a transfer
    xfer_backoff: float = 0.005            # retry backoff base, seconds (jittered
    #   exponential; the jitter never changes the retry count)
    xfer_deadline: float = 30.0            # a transfer's deadline, seconds (0 =
    #   none): retries stop once the next backoff would cross it
    # failure handling (runtime/block.py BlockPolicy: a kernel's own
    # ``policy`` attribute wins over these process defaults)
    block_policy: str = "fail_fast"        # default on_error policy:
    #   "fail_fast" | "restart" | "isolate"
    block_max_restarts: int = 3            # restart budget a block
    block_backoff: float = 0.05            # restart backoff base, seconds
    #   (doubling a attempt, capped at BlockPolicy.backoff_cap)
    block_isolate_groups: str = ""         # "block_name=group;other=group2":
    #   a member's failure retires the whole named subgraph (blocks with no
    #   policy of their own)
    run_timeout: float = 0.0               # Runtime.run deadline, seconds (0 =
    #   none): past it the run is cancelled and raises FlowgraphError
    run_timeout_grace: float = 5.0         # seconds the cancelled run has to
    #   wind down before the deadline path raises anyway
    tpu_checkpoint_every: int = 1          # carry-checkpoint cadence of the
    #   device kernels' recovery: a snapshot every Nth dispatch group, taken
    #   only where a restart can read it (tpu/kernel_block.py); 0 = off
    checkpoint_dir: str = ""               # persist each committed checkpoint
    #   under this directory (utils/snapshot.py), so a new process's kernel
    #   resumes from it; "" = off
    # precision and tuning (ops/precision.py, tpu/autotune.py)
    interior_precision: str = "off"        # "off" | "auto" | "bf16" | "int8":
    #   the SNR-budgeted lowering of a device kernel's interior; off returns
    #   the pipeline unchanged
    interior_snr_budget_db: float = 40.0   # per-edge SNR floor of "auto"
    interior_precision_overrides: str = ""  # per-stage pins,
    #   "fir=off;fft2048=bf16"
    autotune_cache_dir: str = ""           # the streamed-pick cache's JSON
    #   store (tpu/autotune.py); "" = in memory only (the reference's default,
    #   ~/.cache/futuresdr_tpu, lies outside the checkout: set it to persist)
    # the serving plane (serve/engine.py ServeEngine)
    serve_buckets: str = ""                # slot-bucket ladder, e.g. "1,4,16,64";
    #   "" = the cached autotune_serve ladder, else powers of two to 64
    serve_queue_frames: int = 2            # shared admission budget: this many
    #   queued, undispatched frames a slot, divided fairly between tenants
    serve_retired_keep: int = 64           # retired-session views kept
    serve_persist_dir: str = ""            # per-session carry snapshots here,
    #   restored by a new engine of the same app; "" = off
    serve_persist_every: int = 0           # persist every lane every Nth step
    #   (0 = off; evictions and drains persist regardless)
    serve_slo_ms: float = 0.0              # submit→result latency SLO of the
    #   shedding ladder; 0 = queue pressure only
    serve_shed_hi: float = 0.85            # queue-pressure high watermark
    serve_shed_lo: float = 0.50            # low watermark (the ladder unwinds
    #   one rung at a time below it)
    serve_shed_trip: int = 3               # unhealthy steps a rung up
    serve_shed_clear: int = 8              # healthy steps a rung down
    serve_brownout: str = "off"            # the ladder's third rung: "off" |
    #   "k" (megabatch K to 1) | "precision" (the interior lowered)
    serve_brownout_precision: str = "bf16"  # the "precision" rung's mode:
    #   "bf16" or "int8"
    serve_drain_on_sigterm: bool = False   # register_app installs a SIGTERM
    #   hook that drains every registered serving app
    serve_inflight: int = 1                # dispatch groups in flight (1 =
    #   launch, then commit, each step)
    serve_shard_devices: int = 0           # slot-axis sharding of the
    #   serving engine over this many devices (0 or 1 = off); a bucket whose
    #   capacity does not divide by it stays unsharded
    shard: str = "off"                     # the shard plan's mode: "off" |
    #   "auto" | "data" | "model" (shard/plan.py)
    shard_devices: int = 0                 # mesh width of a shard plan (0 =
    #   every device there is)
    # the telemetry plane (telemetry/): spans are off by default, the
    # metrics registry always on
    trace: bool = False                    # FUTURESDR_TPU_TRACE=1 records spans
    #   (telemetry/spans.py; drained as a Chrome trace)
    trace_ring: int = 1 << 16              # a thread's span ring capacity
    doctor: bool = False                   # FUTURESDR_TPU_DOCTOR=1 starts the
    #   stall watchdog (telemetry/doctor.py) with the first Runtime
    doctor_interval: float = 1.0           # watchdog sampling period, seconds
    doctor_window: int = 5                 # no-progress samples before a trip
    doctor_dir: str = ""                   # write flight records here ("" =
    #   memory only, served on GET /api/fg/{fg}/doctor/)
    doctor_action: str = "record"          # "record" | "cancel": a trip also
    #   cancels the wedged flowgraph, whose run then raises FlowgraphError
    lineage_stride: int = 64               # sample 1 frame in N for lineage
    #   records (telemetry/lineage.py); 0 = off, 1 = every frame
    lineage_ring: int = 512                # completed lineage records kept
    journal_ring: int = 1024               # lifecycle events kept (GET
    #   /api/events/, telemetry/journal.py)
    journal_dir: str = ""                  # spool every event as a JSONL line
    #   under this directory ("" = the ring only)
    journal_spool_mb: int = 64             # rotate the spool past this size
    #   (0 = never)
    journal_spool_keep: int = 4            # rotated spool files kept
    fleet_peers: str = ""                  # control-port addresses of the
    #   fleet ("host:port,host:port"; telemetry/fleet.py); "" = off
    fleet_poll_interval: float = 1.0       # peer poll cadence, seconds
    fleet_stale_s: float = 0.0             # a summary older than this reads
    #   stale; 0 = 3 poll intervals
    fleet_down_errors: int = 2             # failed polls before a host is down
    fleet_skew: float = 0.5                # the pressure-skew verdict's limit
    fleet_hysteresis: float = 0.1          # the admission router's switch band
    fleet_host_id: str = ""                # this host's fleet id ("" =
    #   <hostname>:<pid>)
    peak_flops: float = 0.0                # the live gauges' peaks
    peak_hbm_gbps: float = 0.0             #   (telemetry/profile.py): both set
    #   pin them (FLOP/s, GB/s); 0 = the card's published figures
    #   (utils/roofline.detect_peaks), none on the CPU
    virtual_devices: int = 0               # > 0: the device list is that many
    #   logical devices on the first physical one (the CPU, or card 0), the
    #   counterpart of the reference's --xla_force_host_platform_device_count;
    #   0 (off) lists the cards there are
    misc: dict = field(default_factory=dict)   # free-form keys: the
    #   FUTURESDR_TPU_* variables that name no field

    def get(self, key: str, default: Any = None) -> Any:
        """A field by name, else the ``misc`` entry, else ``default`` (the
        reference's free-form lookup)."""
        if key != "misc" and hasattr(self, key):
            return getattr(self, key)
        return self.misc.get(key, default)

    @classmethod
    def from_env(cls) -> "Config":
        c = cls()
        known = set()
        for f in fields(cls):
            if f.name == "misc":
                continue
            # a tpu_ field also reads the reference's short form:
            # FUTURESDR_TPU_WIRE_FORMAT for tpu_wire_format (the prefix
            # already spells the plane); the full name wins
            names = [f.name] + ([f.name[4:]] if f.name.startswith("tpu_") else [])
            known.update(names)
            raw = next((os.environ[_ENV_PREFIX + n.upper()] for n in names
                        if _ENV_PREFIX + n.upper() in os.environ), None)
            if raw is not None:
                setattr(c, f.name, _parse(f.name, f.default, raw))
        c.misc = {k[len(_ENV_PREFIX):].lower(): v for k, v in os.environ.items()
                  if k.startswith(_ENV_PREFIX) and k[len(_ENV_PREFIX):].lower() not in known}
        return c


_config: Optional[Config] = None
_lock = threading.Lock()


def config() -> Config:
    """The process configuration, read from the environment on first use."""
    global _config
    with _lock:
        if _config is None:
            _config = Config.from_env()
        return _config


def reload_config() -> Config:
    """Read the environment again (tests)."""
    global _config
    with _lock:
        _config = Config.from_env()
        return _config
