# Build/test targets (parity with the reference Makefile:61-91, Python-flavored)

PYTHON ?= python3
PYTEST_FLAGS ?= -q
COV_THRESHOLD ?= 85

.PHONY: all check test test-fast test-fault test-chaos test-soak test-scale test-rollout test-latency test-reconfig test-shard test-planner test-budget test-handover test-obs test-federation test-policy test-dag test-precursor test-preflight test-fsck test-torch-gpu lint cov bench bench-reconcile bench-latency bench-shard bench-shard-100k bench-shard-1m bench-planner bench-budget bench-budget-1m bench-obs bench-federation bench-federation-50 bench-precursor bench-preflight profile-pass graft-check package clean diagram

all: lint test

check: lint test cov package

# Regenerate docs/state-diagram.{dot,svg} from consts.STATE_EDGES
# (tests/test_state_diagram.py fails when they drift).
diagram:
	$(PYTHON) tools/state_diagram.py

test:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS)

test-fast:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -x

# Tier-1 unplanned-fault slice: wedge detection, the remediation ladder,
# and lossy-apiserver convergence (marker registered in pyproject.toml).
test-fault:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m fault

# The chaos gate: fixed seeds, tier-1 fast — seeded compound-fault soaks
# with invariant monitoring (docs/chaos-testing.md). A failure prints
# the seed + event trace needed to replay it deterministically.
test-chaos:
	$(PYTHON) -m pytest tests/test_chaos.py $(PYTEST_FLAGS) -m "chaos and not slow"

# Canary-wave / fleet-halt / rollback slice: the RolloutGuard unit +
# e2e tests plus the seeded bad-revision chaos gate (a broken libtpu
# revision must be contained: halt within one reconcile pass, quarantine
# the hash, roll every touched node back to the previous revision).
test-rollout:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "rollout and not slow"

# Degraded-slice reconfiguration slice: reconfigurer units, the
# remediation reconfigure-required arc, joint planning, and the seeded
# reconfiguration chaos gate (k permanent node kills across >= 2 slices
# mid-rollout: every slice must be remapped onto a spare or admitted
# degraded — never silently short).
test-reconfig:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "reconfig and not slow"

# Long randomized soak, outside tier-1. Widen with the env knobs, e.g.:
#   CHAOS_SEEDS=$$(seq -s, 100 199) CHAOS_STEPS=2400 make test-soak
test-soak:
	$(PYTHON) -m pytest tests/test_chaos.py $(PYTEST_FLAGS) -m soak

# In-repo static analyzer (tools/lint.py): always available, fails on
# findings — no silent degradation when external linters are missing
# (the reference pins golangci-lint the same way, Makefile:44-46).
# When ruff/pyflakes exist in the environment they run as an extra
# belt-and-suspenders pass and also fail the target.
lint:
	$(PYTHON) -m compileall -q tpu_operator_libs tools tests examples bench.py __graft_entry__.py
	$(PYTHON) tools/lint.py
	$(PYTHON) tools/metrics_lint.py
	$(PYTHON) tools/marker_lint.py
	$(PYTHON) tools/policy_lint.py
	$(PYTHON) tools/state_keys_lint.py
	@if $(PYTHON) -c "import ruff" 2>/dev/null; then \
		$(PYTHON) -m ruff check tpu_operator_libs tools tests examples; \
	elif $(PYTHON) -c "import pyflakes" 2>/dev/null; then \
		$(PYTHON) -m pyflakes tpu_operator_libs tools tests examples; \
	fi
	@if $(PYTHON) -c "import mypy" 2>/dev/null; then \
		$(MAKE) typecheck; \
	else \
		$(PYTHON) tools/typecheck_report.py; \
	fi

# Static types on the library package, via tools/typecheck_report.py:
# verifies the CI mypy pin / Makefile / pyproject profile are mutually
# consistent, and EXECUTES `python -m mypy tpu_operator_libs` wherever
# mypy is importable (the profile lives ONLY in pyproject's [tool.mypy]
# — strict with targeted relaxations; a CLI --strict would override
# them). One entry point for CI and local, one mypy execution.
.PHONY: typecheck
typecheck:
	$(PYTHON) tools/typecheck_report.py

# Line coverage with a hard gate (reference: Coveralls upload,
# ci.yaml:45-64). Built on sys.monitoring — no external deps.
COV_ARGS ?=
cov:
	$(PYTHON) tools/cov.py --threshold $(COV_THRESHOLD) $(COV_ARGS)

# Wheel build + install into a scratch prefix + import & entry-point
# smoke — proves `pip install tpu-operator-libs` works.
package:
	rm -rf build dist .pkgtest
	$(PYTHON) -m build --wheel --no-isolation -o dist .
	$(PYTHON) -m pip install --quiet --no-deps --target .pkgtest dist/*.whl
	PYTHONPATH=$(CURDIR)/.pkgtest $(PYTHON) -P -c "import tpu_operator_libs; \
		assert '.pkgtest' in tpu_operator_libs.__file__, tpu_operator_libs.__file__; \
		import tpu_operator_libs.examples.libtpu_operator; \
		print('package import OK from', tpu_operator_libs.__file__)"
	rm -rf .pkgtest

bench:
	$(PYTHON) bench.py

# Fleet-scale reconcile pipeline: watch-indexed reads + parallel bucket
# workers + coalesced writes vs the full-relist baseline, 64/256/1024
# nodes (tools/reconcile_bench.py; docs/benchmarks.md §2c).
bench-reconcile:
	$(PYTHON) tools/reconcile_bench.py

# Fleet-scale regression tests (`scale` marker): the tier-1 64-node
# smoke runs in `make test` too; this target adds the big fleets.
test-scale:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m scale

# Zero-idle scheduling: poll-paced vs event-driven wakeups (completion
# nudges + deadline timer wheel + eager slot refill), 64/256/1024
# nodes (tools/latency_bench.py; docs/benchmarks.md §2d).
bench-latency:
	$(PYTHON) tools/latency_bench.py

# Sharded-control-plane slice: ring/elector/fencing/budget-share units,
# the single-replica equivalence pin, the sharded wire smoke (2
# concurrent replicas over sockets), and the replica-kill chaos gate
# (10 fixed seeds: kills/deposes mid-wave, zero shard-invariant
# violations; widen with CHAOS_SEEDS/CHAOS_STEPS via `make test-soak`).
test-shard:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "shard and not slow"

# Sharded-control-plane scale proof: single-owner vs 4 sharded replicas
# on a 16k-node simulated fleet, bit-identical final cluster state with
# per-replica O(partition) read accounting
# (tools/latency_bench.py --shard-nodes; docs/sharded-control-plane.md).
bench-shard:
	$(PYTHON) tools/latency_bench.py --shard-nodes 16384 --shard-replicas 4 --out BENCH_shard.json

# The 100k-node scale proof (slow — ~15-20 min): 102,400 simulated
# nodes, 4 partition-reading replicas vs one single owner; acceptance =
# bit-identical convergence + per-replica steady-state read load within
# ~1.3x of fleet/replicas + zero steady-state full-fleet pod LISTs
# (docs/benchmarks.md §2e). Writes BENCH_shard.json.
bench-shard-100k:
	$(PYTHON) tools/latency_bench.py --shard-nodes 102400 --shard-replicas 4 --out BENCH_shard.json

# The million-node pass: 2**20 synthetic nodes driven to convergence by
# the columnar (struct-of-arrays, vectorized) reconcile kernel AND its
# per-node dict twin — acceptance is a bit-identical final-state
# fingerprint + identical makespan, sub-second worst-case incremental
# builds per replica, per-replica delta intake within 1.3x of
# events/replicas and ZERO steady full-fleet lists
# (tools/latency_bench.py --columnar-nodes; docs/benchmarks.md §2e).
# Writes BENCH_shard.json.
bench-shard-1m:
	$(PYTHON) tools/latency_bench.py --columnar-nodes 1048576 --columnar-replicas 8 --out BENCH_shard.json

# Reconcile-pass profiler: cProfile one steady-state pass at 64 and
# 1024 nodes, print the top-20 cumulative hotspots and refresh the
# PROFILE-PASS block in docs/benchmarks.md (tools/profile_pass.py).
profile-pass:
	$(PYTHON) tools/profile_pass.py

# Event-driven scheduling regressions (`latency` marker): timer wheel,
# nudge dedup, eager refill, and the 64-node bench smoke are tier-1;
# the 256/1024-node makespan-ratio cells are also marked slow.
test-latency:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m latency

# Cost-aware predictive wave planner slice (`planner` marker):
# predictor/LPT/window units, planner-chain composition, the 64-node
# bench smoke, and the seeded maintenance-window chaos gate are
# tier-1; the 256/1024-node acceptance cells are also marked slow.
test-planner:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "planner and not slow"

# Cost-aware predictive wave planning: flat admission order vs
# learned-duration LPT packing on seeded heterogeneous 256/1024-node
# fleets — ≥1.2x makespan win, ≤15% predicted-vs-actual makespan
# error, bit-identical final state (tools/planner_bench.py;
# docs/benchmarks.md §2f). Writes BENCH_planner.json.
bench-planner:
	$(PYTHON) tools/planner_bench.py --nodes 256,1024 --out BENCH_planner.json

# Traffic-aware capacity budget slice (`budget` marker): controller
# units, the safe mid-flight abort arc (incl. operator crash
# mid-abort), policy/CRD round-trips, the bench smoke, and the
# 256-node diurnal-replay chaos gate seeds 1-3 (4-10 slow; widen via
# `pytest -m budget`).
test-budget:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "budget and not slow"

# Zero-drop handover slice (`handover` marker): traffic-class spec /
# ServingEndpoint validation units, DisruptionCostRanker ordering +
# sole-replica holds, the PrewarmCoordinator reserve->ready->release
# arc (incl. crash-mid-prewarm resume), router-side session handover,
# and the 256-node class-aware diurnal-replay chaos gate at 2x the
# budget gate's traffic — zero operator-dropped generations per
# session id, zero interactive SLO breaches, zero prewarm residue.
# Seeds 1-3 tier-1, 4-10 slow (CHAOS_SEEDS-style widening via slow).
test-handover:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "handover and not slow"

# Multi-cluster federation slice (`federation` marker): ledger/
# controller/policy units, explain_region, the bench smoke, and the
# two seeded federation chaos gates — regional-controller kills,
# federation<->region partitions and federation-controller kills on
# the good-path rollout (seeds 1-3 tier-1, 4-10 slow), plus the
# bad-revision containment flavor (canary region halts, quarantine
# lifts fleet-wide, zero non-canary admissions). Widen with
# CHAOS_SEEDS like the other gates.
test-federation:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "federation and not slow"

# Federation rollout proof: 4 simulated regions, fault-free —
# region-as-canary makespan + canary-halt -> fleet-quarantine latency
# with zero non-canary bad admissions (tools/federation_bench.py;
# docs/benchmarks.md §2i). Writes BENCH_federation.json.
bench-federation:
	$(PYTHON) tools/federation_bench.py --out BENCH_federation.json

# 50-region read-path proof: one full rollout + 20 steady-state
# passes under the watch-driven read path vs the polled baseline —
# acceptance is >= 10x fewer steady-state read objects with a
# bit-identical final fleet state and zero session drops
# (docs/benchmarks.md §2i). Merges the cell into BENCH_federation.json.
bench-federation-50:
	$(PYTHON) tools/federation_bench.py --scale50 --out BENCH_federation.json

# Declarative policy-engine slice (`policy` marker): the sandboxed
# expression language, the hook registry's fail-closed/fail-open
# contract, spec/CRD validation, the park-not-wedge property (an
# erroring or over-budget program parks its node, audited, explain()
# non-empty — never a crashed pass), and policy_lint self-checks.
test-policy:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "policy and not slow"

# Multi-artifact upgrade-DAG slice (`dag` marker): ArtifactDAGSpec
# validation (cycle/unknown-dep rejection), the coordinator's
# dependency-ordered advance with crash-ordered stamps, quarantine +
# dependent-suffix rollback, crash-mid-DAG resume, and the seeded DAG
# chaos gate (run_dag_soak: compound faults + a node kill + a bad
# mid-DAG artifact revision; always-on dag-order/policy-sandbox
# invariants). Seeds 1-3 tier-1, 4-10 slow (the standing convention).
test-dag:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "dag and not slow"

# Upgrade-journey tracing + decision-audit slice (`obs` marker):
# tracer/audit units, explain-under-sharding incl. the handover
# regression, exposition round-trips (golden file, exemplars,
# cardinality guard), metrics_lint self-checks, and the bench smoke.
test-obs:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "obs and not slow"

# Observability overhead proof: the 1024-node pipelined upgrade with
# and without the journey tracer + decision audit installed —
# acceptance is <3% added pass time and a bit-identical final state
# (tools/reconcile_bench.py --obs; docs/observability.md §7). Writes
# BENCH_obs.json.
bench-obs:
	$(PYTHON) tools/reconcile_bench.py --obs --out BENCH_obs.json

# Traffic-aware budgets vs static maxUnavailable on the diurnal
# serving replay: peak-safe static (slow, safe) vs aggressive static
# (fast, breaches the capacity SLO) vs the capacity controller (fast
# AND safe — zero dropped generations, zero shortfall ticks)
# (tools/budget_bench.py; docs/traffic-aware-budgets.md). Writes
# BENCH_budget.json.
bench-budget:
	$(PYTHON) tools/budget_bench.py --out BENCH_budget.json

# The million-session handover soak: the vectorized serving-fleet twin
# (chaos/serving_vec.py) replays >1M concurrent sessions through
# drain-wave handovers — acceptance is ZERO operator-attributed drops
# with session-conservation intact (tools/budget_bench.py
# --vector-sessions; docs/benchmarks.md §2g). Writes BENCH_budget.json.
bench-budget-1m:
	$(PYTHON) tools/budget_bench.py --vector-sessions 1048576 --out BENCH_budget.json

# Failure-precursor slice (`precursor` marker): NodeHealthSignal +
# FailurePrecursorModel units (EWMA rates, verdict streaks, durable
# seed resume), the at-risk condemn-before-fail arc (remap while
# serving, planned drain, fleet budget, zero-residue stand-down,
# wedge takeover), crash-mid-condemnation resume, explain()/ranker
# integration, and the seeded degradation-then-death chaos gate
# (run_precursor_soak). Seeds 1-3 tier-1, 4-10 slow (the standing
# convention).
test-precursor:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "precursor and not slow"

# Condemn-before-fail vs the reactive ladder on the seeded
# degradation-then-death episode: predictive must pay ZERO victim
# downtime and drop ZERO sessions while the reactive baseline pays
# both, final states bit-identical modulo the precursor's own stamps
# (tools/precursor_bench.py; docs/auto-remediation.md). Writes
# BENCH_precursor.json.
bench-precursor:
	$(PYTHON) tools/precursor_bench.py --out BENCH_precursor.json

# Rollout-preflight slice (`preflight` marker): the frozen-clone
# write tripwire (every FakeCluster mutating path rejects when
# frozen), forecast units (LPT makespan + error-histogram confidence
# bounds, SLO replay, policy-hook holds, window deferrals), the
# required-mode admission gate (audited park, non-empty explain,
# zero admissions), crash-mid-forecast resume, status/HTTP/federation
# surfacing, and the seeded read-only chaos gate (run_preflight_soak:
# the budget fleet's compound-fault storm with the forecaster live on
# every pass; preflight-readonly + storm-grade calibration + the
# post-convergence required-mode hold probe). Seeds 1-3 tier-1, 4-10
# slow (the standing convention).
test-preflight:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "preflight and not slow"

# Forecast-vs-realized calibration proof: learn a rollout, preflight
# the next, then realize it fault-free on the standing 256- and
# 1024-node bench fleets — acceptance is forecast makespan within 15%
# of realized with the confidence interval covering the realized
# value (tools/preflight_bench.py; docs/preflight.md). Writes
# BENCH_preflight.json.
bench-preflight:
	$(PYTHON) tools/preflight_bench.py --nodes 256,1024 --out BENCH_preflight.json

# Durable-state fsck slice (`fsck` marker): registry completeness
# (every owned key literal resolves, enforced by tools/state_keys_lint
# in `make lint`), auditor classification units (garbage / orphaned /
# conflicting / version-skewed), janitor repair + quarantine ordering,
# codec corruption round-trips, 409/410 apiserver-semantics
# regressions, and the seeded corruption chaos gate (run_fsck_soak:
# adversarial stamp corruption between reconciles; acceptance = no
# corrupted stamp drives a decision, every repair audited with a
# non-empty explain() chain, post-soak fleet fingerprint bit-identical
# to the corruption-free twin run). Seeds 1-3 tier-1, 4-10 slow (the
# standing convention).
test-fsck:
	$(PYTHON) -m pytest tests/ $(PYTEST_FLAGS) -m "fsck and not slow"

# The PyTorch port's CUDA kernels against their plain versions, on a
# machine with a card (every test skips without CUDA).
test-torch-gpu:
	$(PYTHON) -m pytest tests/test_torch_gpu.py $(PYTEST_FLAGS) -m gpu

graft-check:
	$(PYTHON) __graft_entry__.py

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
	rm -rf .pytest_cache .coverage build dist .pkgtest *.egg-info
