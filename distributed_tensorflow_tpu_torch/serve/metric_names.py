"""Metric families scraped outside the package — the rename choke point.

This package's copy of ``distributed_tensorflow_tpu/serve/metric_names.py``.

Registration (``obs/metrics.py`` call sites) and scraping (loadgen,
bench, bench_diff) live on opposite sides of a process boundary joined
only by a string. A rename on the registration side leaves the scraper
reading nothing, and because several bench FLOORS gate on "value
present", a drifted name silently un-gates a floor. Every name the
external scrapers match against ``sample["name"]`` therefore lives
here, so a rename is a one-line diff and ``dttlint``'s ``metric-drift``
rule can check each constant against the registered families.

Pure constants — no imports, safe from any tool without JAX installed.
"""

RECOMPILE_EVENTS_TOTAL = "recompile_events_total"

SERVE_PREFIX_HIT_RATE = "serve_prefix_hit_rate"
SERVE_SPEC_ACCEPT_RATE = "serve_spec_accept_rate"
SERVE_SPEC_ACCEPT_RATE_BY_DRAFTER = "serve_spec_accept_rate_by_drafter"
SERVE_SPEC_ACCEPT_PER_VERIFY = "serve_spec_accept_per_verify"
SERVE_SPEC_ACCEPTED_PER_VERIFY_P50 = "serve_spec_accepted_per_verify_p50"
SERVE_SPEC_ACCEPTED_PER_VERIFY_P99 = "serve_spec_accepted_per_verify_p99"

SERVE_WEIGHT_BYTES_PER_DEVICE = "serve_weight_bytes_per_device"
SERVE_KV_BYTES_PER_TOKEN = "serve_kv_bytes_per_token"

SERVE_HANDOFF_TOTAL = "serve_handoff_total"
SERVE_HANDOFF_STALL_SECONDS_TOTAL = "serve_handoff_stall_seconds_total"
FLEET_HANDOFF_BYTES_TOTAL = "fleet_handoff_bytes_total"

FLEET_ROLLOUT_TOTAL = "fleet_rollout_total"
FLEET_ROLLOUT_REPLICAS_CURRENT = "fleet_rollout_replicas_current"
