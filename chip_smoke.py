#!/usr/bin/env python3
"""Smoke test of kubernetes_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from kubernetes_tpu_torch/csrc (nvcc,
one process per source, all started together: K1-K14), then:

  1. main paths, each with the kernel launch counts zeroed just before
     and read just after it; every kernel of the path must have launched:
     - `uniform` and `spread`: 50,000 pods onto 5,000 nodes through the
       port's BatchScheduler, in batches of 16,384 — `uniform` through
       the chained schedule_launch -> schedule_finish drain
       (scheduler/drain.py), `spread` (SelectorSpread groups over zone
       and hostname) one batch after another (K1, K2; K3 on spread);
     - `scheduler`: the scheduler loop as production runs it —
       Scheduler(client, batch_size=16384, device="cuda").drain_pipelined
       with the commit thread on, over a cluster built through the port's
       Client as bench.py's run_config builds it: 50,000 pods of nine
       tenants (priority 1000 for every fourth pod) onto 5,000 nodes.
       Every popped batch is ordered by DRF on the card (K4, K5, at least
       4 launches each), then scanned (K1, K2).
     - `anti-affinity` and `preferred`: the same scheduler loop, single
       tenant, over bench.py run_config's clusters of its
       `pod-anti-affinity` (required anti-affinity within 100 colors on
       kubernetes.io/hostname, with its 100 seeded colored pods) and
       `preferred-affinity` (preferred anti-affinity, weight 10, within
       16 groups on the hostname, at the default InterPodAffinityPriority
       weight) pods: 10,000 pods onto 1,000 nodes, BASELINE.json's
       configs 3 and 4. Their batches carry K2's topology counters and
       soft credits (the class_scan_topo and class_scan_soft instances).
     - `service-anti-affinity`: the same scheduler loop, single tenant,
       at the north-star size: 50,000 pods of bench.py's three request
       shapes in 1,000 services of 50 replicas (workload.service_pod:
       label app = svc-{i % 1000}, required anti-affinity to its own
       service on kubernetes.io/hostname) onto 5,000 nodes. Every batch
       carries about 1,000 constraint templates over 1,000-2,000 terms,
       so TopologyIndex.required_masks evaluates them on the card
       (U·T·capacity >= DEVICE_EVAL_THRESHOLD: kernel K13
       affinity_masks); each call's rows are held bit for bit against the
       host route (the same call with the threshold raised). The batch's
       in-scan terms exceed the BatchScheduler's TOPO_TERM_CAP (512), so
       K2 runs its plain class_scan instance and the repair overlay keeps
       two replicas of a service off one node, as in the reference;
     - `affinity-scores`: kernels.affinity.affinity_scores (K14) on
       integer inputs of the largest K13 call's shapes; no scheduler
       route calls it, in the reference neither;
     - `nominated`: the same scheduler loop over bench.py's `nominated`
       variant at its own size, 5,000 uniform pods onto 5,000 nodes with a
       ghost preemptor nominated to every fourth node: K1 folds the
       phantom reservations into feasibility and K2 runs its nominated
       instance (class_scan_nom) on every batch;
     - `storm`: bench.py preempt_main's preemption storm at 5,000 nodes
       (3 bound victims of priority 0/10/100 on every node, a PodGroup
       member on every fourth, a PodDisruptionBudget over band b0): 150
       preemptors of 2 CPU / 3Gi at priority 1000 through
       BatchScheduler.preempt, each plan's victims removed from the cache
       (K6 price_nodes prices every candidate node on each), then the same
       storm through the serial reprieve control (KTPU_PREEMPT_KERNEL=0),
       plans/s of both printed;
     - `preemption`: the same cluster created through the port's Client
       (with the PDB object), 150 preemptors created pending, and
       Scheduler.drain_pipelined with preemption on until nothing is
       pending: each preemptor is priced (K6), nominated, evicts its
       victims, and lands through the nominated overlay (K1's fold, K2's
       class_scan_nom with the nominee's own row exempt). The informer
       events are delivered on the drain's thread (workload.InformerPump)
       and a FakeClock steps past backoffs.
     - the classic per-pod route (KTPU_CLASS_SCAN=0: batches without
       class tables, kernel K7 pod_scan, one launch per batch) over the
       same clusters: `classic` and `classic-spread`, the uniform and
       spread stand-in drains at 50,000 pods onto 5,000 nodes, whose binds
       must equal the class route's binds of the same run;
       `classic-anti-affinity`, `classic-preferred` and
       `classic-nominated`, the scheduler loops of those paths under the
       same gates (pod_scan_topo, _soft, _nom). No class-route kernel may
       launch on them;
     - `filter`: kernels.filter_score (K8), the [P, N] fits and scores,
       on the uniform and spread paths' first batches (16,384 pods x
       8,192 rows); no scheduler route calls it;
     - `gang`: BASELINE.json config 5, 50,000 pods onto 5,000 nodes
       labelled tpu/slice = s{i // 8} (625 slices of 8): 2,000 PodGroups
       of 8 with topologyKey tpu/slice, 2,000 PodGroups of 4 without a
       key and 26,000 singletons of bench.py's three request shapes
       (workload.gang_objects), created through the port's Client and
       drained by Scheduler.drain_pipelined in batches of 16,384 (the
       informer events delivered on the drain's thread by
       workload.InformerPump, a FakeClock stepped past backoffs): every
       batch carries PodGroup members and takes the all-or-nothing gang
       scan K9 (its capacity-gated instance gang_scan_cap);
     - `gang-feasible`: K8's [P, N] mask of the gang path's largest batch
       and kernels.gang_feasible (K10) over its gangs; no scheduler route
       calls it;
     - `gang-storm`: bench.py preempt_main's gang_preempt at 5,000 nodes:
       the storm cluster, 2 BatchScheduler.preempt_gang calls for a gang
       of 8 with no topology key (the whole cluster one domain row of
       every victim unit, U = 16,384), then 15 repeats for a gang of 8
       members of 2 CPU / 3Gi at priority 1000, minMember 8, tpu/slice,
       each pricing the 625 slices in one launch of K11 price_domains;
       plans/s, and the host time of build_domain_tables;
     - `gang-preemption`: the storm cluster through the Client and 10
       such gangs arriving one after another, each drained until it is
       bound (workload.drain_until_idle): priced (K11), its members
       nominated across the winner slice's freed nodes, the chosen units
       evicted, and the gang lands through the nominated overlay (K9's
       gang_scan_cap_nom, its members exempt from their gang-mates'
       reservations).
     - `speculative` and `speculative-anti-affinity`: the speculative
       cohort route (Scheduler(speculative=True), K12 spec_scan) with the
       divergence oracle on (KTPU_SPEC_ORACLE=1: schedule_finish replays
       each batch through K1 + K2): the `scheduler` path's nine-tenant
       50,000 pods onto 5,000 nodes (the contention gate at its default),
       then BASELINE.json config 3 (10,000 anti-affinity pods onto 1,000
       nodes) with the gate forced open, as bench.py _spec_point forces
       it, so that every cohort repairs (spec_scan_topo); likewise the
       `preferred` (gate forced open, spec_scan_soft) and `nominated`
       (spec_scan_nom) loops, which must bind as their serial paths did,
       and `speculative-spread`, the stand-in spread drain with the
       route and the oracle on the BatchScheduler (gate forced open,
       spec_scan_spread), which must bind as `spread` did.
     Every pod must bind (in the store, for the scheduler loops), no
     node's usage recomputed from the binds (the ghost reservations
     counted on `nominated`) may exceed its allocatable, on
     `anti-affinity` paths no two pods of a color (of a service) may
     share a node, on
     the speculative paths the oracle must count no divergence, on
     `preemption` and `gang-preemption` every evicted victim must rank
     below its preemptor and preemption_attempts must equal the plans
     made, every PodGroup binds whole and every tpu/slice gang inside one
     slice, and a victim PodGroup is evicted whole or not at all;
  2. the `uniform`, `spread`, `anti-affinity`, `preferred` and
     `nominated` drains with the plain versions on the card (the kernels
     patched out in this script only): the binds must be equal. `uniform`
     and `spread` are cut to their first batch here (PLAIN_PODS), which
     binds as in the whole drain, and the `gang` drain to its largest
     (first) batch, held bit for bit in the kernel phase, to keep the
     script inside its time; the first scan of each drain is kept for
     the kernel phase;
  3. kernel phase: each kernel on the inputs the main paths gave it, held
     bit for bit against its plain PyTorch version on the card, and
     timed with CUDA events beside the plain version and, where one
     PyTorch call computes the same function, that call. Each K2
     instance is held on a whole batch of its path (the first batch of
     its plain drain in phase 2, whose inputs must equal the recorded
     batch's bit for bit; else the plain versions run again); every
     launch of the
     nominated instance on the `nominated` and `preemption` paths, and
     every one of the storm's 150 K6 decisions (winner, chosen units,
     prefix lengths, PDB violations), is held against its plain version.
     Each K7 instance replays the batch of its K2 instance's path with the
     class tables dropped: its assign must equal K2's row for row, and
     on the batch's first 2,048 pods (POD_SCAN_PLAIN_PODS) its packed
     results and post-batch usage its plain version's bit for bit. K8 runs on the uniform and spread batches against its plain
     version (fits equal, score bits equal). Each K9 instance is held on
     the largest batch of its path (assign, the score bits of every pod,
     rejected gangs' members included, and the committed usage bits), and
     replays the uniform path's first batch as singletons in pod order,
     where its assign and the active pods' score bits must equal K7's;
     gang_scan_cap_nom with the own-gang exemption also replays the gang
     path's largest batch cut to its first 2,048 entries (whole units;
     the gangs among every fourth unit hold reservations, two to a node);
     K10 on the gang-feasible path's mask; every K11 decision of the gang
     storm and the gang-preemption loop (winner, chosen units, PDB
     violations) against price_domains_plain. Each K12 instance replays
     the batch of its K2 instance's path at full size and the default
     cohort width, the gate forced open: its assign, active pods' score
     bits and usage finals must equal K2's (a padding pod's score is its
     frozen pick's, as in the JAX speculative kernel), and on a prefix of
     the batch (2,048 pods of the uniform and anti-affinity batches, 256
     of the others) everything, the cohort stats included, its plain
     version's; it is timed beside K2 on the same batch, with its
     accepted-cohort and repaired-pod shares, and on the uniform batch at
     cohort widths 8, 16 and 32. K13 runs the largest required_masks
     call of the service-anti-affinity path and K14 integer inputs of
     its shapes (weights in [-100, 100], counts in [0, 50]), each held
     bit for bit against its plain version on the card;
  4. small drains (128 nodes, 1,024 pods) on the card against the same
     drains on the CPU: for `uniform` and `spread` the binds and score
     bits must be equal; for the nine-tenant scheduler loop (with
     KTPU_COMMIT_THREAD=0, the only setting whose multi-tenant order does
     not depend on thread timing) the binds and the DRF shares' bits;
     for the preemption loop (400 nodes, 30 preemptors, the same
     setting) the binds, the evicted victims and the nominations; for the
     nine-tenant loop with KTPU_CLASS_SCAN=0 (K7) the binds; for the gang
     drain (128 nodes, 1,024 pods, gangs in proportion) the binds; for the
     gang-preemption loop (400 nodes, 2 gangs) the binds, evicted victims
     and nominations; for the nine-tenant loop with
     Scheduler(speculative=True) (K12) the binds and the speculative
     counters.

It prints a `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_NODES = 5000
N_PODS = 50_000
BATCH = 16_384
SMALL_NODES, SMALL_PODS, SMALL_BATCH = 128, 1024, 256
#: the depth of the uniform and spread drains with the plain versions
PLAIN_PODS = BATCH
#: BASELINE.json configs 3 and 4: 10k pods onto 1k nodes
AFF_NODES, AFF_PODS = 1000, 10_000
#: bench.py's `nominated` variant at its own size (its AFF_NODES and
#: AFF_PODS), ghost nominations on every fourth node
NOM_NODES, NOM_PODS = 5000, 5000
#: the scheduler-loop paths: bench.py variant, nodes, pods
SCHED_PATHS = {"anti-affinity": ("pod-anti-affinity", AFF_NODES, AFF_PODS),
               "preferred": ("preferred-affinity", AFF_NODES, AFF_PODS),
               "nominated": ("nominated", NOM_NODES, NOM_PODS)}
#: bench.py preempt_main's storm at BASELINE.json's north-star cluster
#: (5,000 nodes in place of the bench's default 400), and the small
#: version held between the card and the CPU
STORM_NODES, STORM_PODS = 5000, 150
SMALL_STORM_NODES, SMALL_STORM_PODS = 400, 30
#: the storm's preemptor priority (workload.storm_preemptor)
PREEMPTOR_PRIORITY = 1000
#: the scheduler path's tenants (bench.py tenancy_main's nine steady
#: tenants) and its priority mix (every fourth pod at 1000)
N_TENANTS = 9
#: the classic per-pod route (KTPU_CLASS_SCAN=0, kernel K7) over the
#: same clusters: stand-in drains (path -> the class path it must bind
#: as, chained) and scheduler loops (bench.py variant, nodes, pods)
CLASSIC_DRAINS = {"classic": ("uniform", True),
                  "classic-spread": ("spread", False)}
CLASSIC_SCHED = {"classic-anti-affinity": SCHED_PATHS["anti-affinity"],
                 "classic-preferred": SCHED_PATHS["preferred"],
                 "classic-nominated": SCHED_PATHS["nominated"]}
#: BASELINE.json config 5 (the gang drain): pods, nodes, PodGroups of 8
#: on one tpu/slice and PodGroups of 4 without a key (the rest
#: singletons); its small copy held between the card and the CPU
GANG_NODES, GANG_PODS, GANG_SLICE_GANGS, GANG_PLAIN_GANGS = \
    5000, 50_000, 2000, 2000
SMALL_GANG = (SMALL_NODES, SMALL_PODS, 40, 40)
#: bench.py preempt_main's gang_preempt at 5,000 nodes: repeats of
#: preempt_gang, and the gangs of the gang-preemption loop (and of its
#: small copy on 400 nodes)
GANG_STORM_REPEATS = 15
#: the gang storm's preempt_gang calls for a gang of 8 with no topology
#: key (the whole cluster is one domain row, every victim unit in it)
GANG_STORM_KEYLESS = 2
#: the gang batch's entries K9's exempt-mates replay takes (whole units)
MATES_REPLAY_ENTRIES = 2048
GANG_PREEMPT_GANGS = 10
SMALL_GANG_PREEMPT = (SMALL_STORM_NODES, 2)
#: the speculative cohort route (Scheduler(speculative=True), K12) through
#: the scheduler loop with the divergence oracle on (KTPU_SPEC_ORACLE=1):
#: path -> (bench.py variant, nodes, pods, contention gate forced open as
#: bench.py _spec_point forces it)
SPEC_SCHED = {"speculative": ("tenants", N_NODES, N_PODS, False),
              "speculative-anti-affinity": ("pod-anti-affinity", AFF_NODES,
                                            AFF_PODS, True),
              "speculative-preferred": ("preferred-affinity", AFF_NODES,
                                        AFF_PODS, True),
              "speculative-nominated": ("nominated", NOM_NODES, NOM_PODS,
                                        False)}
#: the class path each single-tenant speculative loop must bind as (the
#: same cluster through K2: speculation changes no decision)
SPEC_BINDS_AS = {"speculative-anti-affinity": "anti-affinity",
                 "speculative-preferred": "preferred",
                 "speculative-nominated": "nominated"}
#: the stand-in spread drain with the speculative route and the oracle
#: on the BatchScheduler (the gate forced open: every pod is in a spread
#: group), which must bind as the `spread` path did
SPEC_DRAINS = {"speculative-spread": "spread"}
#: the K12 instances, each replayed on the batch of its K2 instance's path
#: (SCAN_ROWS)
SPEC_ROWS = (("spec_scan", "uniform"), ("spec_scan_spread", "spread"),
             ("spec_scan_topo", "anti-affinity"),
             ("spec_scan_soft", "preferred"), ("spec_scan_nom", "nominated"))
#: pods of the prefix on which K12 is held against its plain version (the
#: plain version takes about 1.6 ms a pod on the card): 2,048 of the
#: uniform batch (mostly clean cohorts) and of the anti-affinity batch
#: (every cohort repaired), SPEC_PLAIN_OTHER of the others
SPEC_PLAIN_PODS = {"uniform": 2048, "anti-affinity": 2048}
SPEC_PLAIN_OTHER = 256
#: pods of the prefix on which each K7 instance is held against its plain
#: version (about 1.3-2.3 ms a pod on the card); its assign is held
#: against K2's on the whole batch
POD_SCAN_PLAIN_PODS = 2048
#: cohort widths swept on the uniform batch (bench.py _spec_kernel_micro)
SPEC_WIDTHS = (8, 16, 32)
#: the service-anti-affinity path: 1,000 services of 50 replicas, each
#: replica with required anti-affinity to its own service on the hostname
#: (workload.service_pod), through the scheduler loop at the north-star
#: size: every constrained batch evaluates its templates on the card (K13)
SVC_PATHS = {"service-anti-affinity": ("service-anti-affinity", N_NODES,
                                       N_PODS)}
#: the seed of K14's integer inputs in the kernel phase
SCORES_SEED = 0
#: the per-pod rows of a device batch (PodBatchTensors.device): a prefix
#: of the batch cuts these
POD_AXIS = ("req", "nonzero_req", "mem_pressure_blocked", "active", "seq",
            "mask_idx", "score_idx", "nom_row", "spread_gidx",
            "spread_match", "anti_tids", "aff_tids", "match_tids",
            "cmatch_tids", "canti_tids", "soft_base_idx", "soft_read_tids",
            "soft_read_w", "soft_write_tids", "soft_write_w", "class_idx",
            "spec_plain")
#: kernels each main path must launch
PATH_KERNELS = {"uniform": ("class_ms_init", "class_scan"),
                "spread": ("class_ms_init", "class_scan_spread",
                           "apply_dirty"),
                "scheduler": ("class_ms_init", "class_scan", "drf_dominant",
                              "drf_order"),
                "anti-affinity": ("class_ms_init", "class_scan_topo"),
                "preferred": ("class_ms_init", "class_scan_soft"),
                "nominated": ("class_ms_init", "class_scan_nom"),
                "storm": ("price_nodes",),
                "preemption": ("price_nodes", "class_ms_init",
                               "class_scan_nom"),
                "classic": ("pod_scan",),
                "classic-spread": ("pod_scan_spread", "apply_dirty"),
                "classic-anti-affinity": ("pod_scan_topo",),
                "classic-preferred": ("pod_scan_soft",),
                "classic-nominated": ("pod_scan_nom",),
                "filter": ("filter_score", "filter_score_spread"),
                "gang": ("gang_scan_cap",),
                "gang-feasible": ("filter_score", "gang_feasible"),
                "gang-storm": ("price_domains",),
                "gang-preemption": ("price_domains", "gang_scan_cap_nom"),
                "speculative": ("class_ms_init", "spec_scan", "drf_dominant",
                                "drf_order"),
                "speculative-anti-affinity": ("class_ms_init",
                                              "spec_scan_topo"),
                "speculative-preferred": ("class_ms_init", "spec_scan_soft"),
                "speculative-nominated": ("class_ms_init", "spec_scan_nom"),
                "speculative-spread": ("class_ms_init", "spec_scan_spread"),
                "service-anti-affinity": ("affinity_masks", "class_ms_init",
                                          "class_scan"),
                "affinity-scores": ("affinity_scores",)}
#: the K9 instances, each held and timed on the largest batch of the
#: path named
GANG_ROWS = (("gang_scan_cap", "gang"),
             ("gang_scan_cap_nom", "gang-preemption"))
#: the K2 instances, each timed and held on a batch of the path named
SCAN_ROWS = (("class_scan", "uniform", "batch.py:596"),
             ("class_scan_spread", "spread", "batch.py:163"),
             ("class_scan_topo", "anti-affinity", "batch.py:366"),
             ("class_scan_soft", "preferred", "batch.py:254"),
             ("class_scan_nom", "nominated", "batch.py:515"))
#: the K7 instances, each replayed on the class route's batch of the path
#: named (its class tables dropped), with the part of the classic branch
#: it replaces
POD_SCAN_ROWS = (("pod_scan", "uniform", "batch.py:652"),
                 ("pod_scan_spread", "spread", "batch.py:735"),
                 ("pod_scan_topo", "anti-affinity", "batch.py:720"),
                 ("pod_scan_soft", "preferred", "batch.py:727"),
                 ("pod_scan_nom", "nominated", "batch.py:705"))
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
#: outside the tensor cores; the bound of a kernel is the larger of its
#: bytes over the first and its f32 operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def env_set(name: str, value: str):
    """The environment variable set for the block, restored after it."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def spec_gate(port, forced: bool):
    """The speculative route's contention gate (KTPU_SPEC_MIN_PLAIN, read
    when the module is imported) forced open for the block when
    `forced`, as bench.py _spec_point forces it."""
    saved = port.sk._SPEC_MIN_PLAIN
    if forced:
        port.sk._SPEC_MIN_PLAIN = 0.0
    try:
        yield
    finally:
        port.sk._SPEC_MIN_PLAIN = saved


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- fixtures


class Port:
    """The port's modules, imported once the checks above passed."""

    def __init__(self):
        import torch
        from kubernetes_tpu_torch import api, workload
        from kubernetes_tpu_torch.scheduler import drain as drain_mod
        from kubernetes_tpu_torch.scheduler.cache import Cache
        from kubernetes_tpu_torch.scheduler.core import BatchScheduler
        from kubernetes_tpu_torch.scheduler import topology
        from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
        from kubernetes_tpu_torch.scheduler.kernels import batch as kb
        from kubernetes_tpu_torch.scheduler.kernels import filter_score
        from kubernetes_tpu_torch.scheduler.kernels import gang as gk
        from kubernetes_tpu_torch.scheduler.kernels import preempt as pk
        from kubernetes_tpu_torch.scheduler.kernels import speculative as sk
        from kubernetes_tpu_torch.scheduler.nodeinfo import (NodeInfo,
                                                              pod_resource)
        from kubernetes_tpu_torch.scheduler.priorities import SpreadListers
        from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
        from kubernetes_tpu_torch.scheduler.tensorize import \
            precompute_pod_features
        from kubernetes_tpu_torch.state import Client
        from kubernetes_tpu_torch.tenancy import TENANT_LABEL
        from kubernetes_tpu_torch.tenancy import kernels as tk
        from kubernetes_tpu_torch.utils.clock import FakeClock
        self.Scheduler, self.Client, self.tk = Scheduler, Client, tk
        self.pk, self.gk, self.FakeClock = pk, gk, FakeClock
        self.sk, self.ak, self.topology = sk, ak, topology
        self.precompute = precompute_pod_features
        self.TENANT_LABEL = TENANT_LABEL
        self.torch, self.api, self.wl = torch, api, workload
        self.drain, self.kb = drain_mod.drain, kb
        self.filter_score = filter_score
        self.Cache, self.BatchScheduler = Cache, BatchScheduler
        self.NodeInfo, self.pod_resource = NodeInfo, pod_resource
        self.SpreadListers = SpreadListers

    def scheduler(self, n_nodes, variant, device):
        return self.wl.build(self.api, self.Cache, self.BatchScheduler,
                             self.SpreadListers, n_nodes, variant,
                             device=device)

    def pods(self, n, variant):
        return [self.wl.make_pod(self.api, i, variant) for i in range(n)]

    def tenant_pod(self, i):
        """bench.py's uniform pod i of tenant t{i % 9}, priority 1000 for
        every fourth pod (the DRF parity mix of bench.py tenancy)."""
        pod = self.wl.make_pod(self.api, i)
        pod.metadata.labels[self.TENANT_LABEL] = f"t{i % N_TENANTS}"
        pod.spec.priority = 1000 if i % 4 == 3 else 0
        return pod

    def launches(self):
        return {**self.kb.LAUNCHES, **self.tk.LAUNCHES, **self.pk.LAUNCHES,
                **self.gk.LAUNCHES, **self.sk.LAUNCHES, **self.ak.LAUNCHES}

    def reset_launches(self):
        self.kb.reset_launches()
        self.tk.reset_launches()
        self.pk.reset_launches()
        self.gk.reset_launches()
        self.sk.reset_launches()
        self.ak.reset_launches()


class Recorder:
    """Wraps the kernel entry points to keep (a copy of) the inputs the
    main path hands them, and brackets each call with CUDA events so the
    device time of the scan calls (K1 + K2 and the carry copies) and of
    the scatters (K3) can be summed per drain; the wrapped call itself is
    unchanged."""

    def __init__(self, port):
        self.kb, self.tk, self.pk = port.kb, port.tk, port.pk
        self.gk, self.sk, self.ak = port.gk, port.sk, port.ak
        #: (variant, start event, end event) of every K13 launch
        self.mask_events = []
        #: path -> K2's (packed, post-batch usage) on its recorded batch
        #: (scan_row), which K12's replay must equal
        self.k2_out = {}
        #: path -> (inputs, packed, post-batch usage, host ms) of the first
        #: scan of its drain with the plain versions on the card (FirstScan),
        #: which scan_row holds K2 against when the inputs equal the
        #: recorded batch's
        self.plain_first = {}
        #: (variant, K9 instance) -> the (node_cfg, usage, pod batch, gang
        #: table, nom, exempt_mates) of its launch with the most entries
        #: (the first of them)
        self.gang_inputs = {}
        self._gang_entries = {}
        #: while a list: every price_domains call's (inputs, outputs)
        self.domain_log = None
        #: the gang storm's and the gang-preemption loop's calls
        self.storm_domains = []
        self.loop_domains = []
        #: seconds of every build_domain_tables call (host)
        self.domain_tables_s = []
        #: (fits [P, N], members [G, M]) of the gang-feasible path
        self.feasible_inputs = None
        #: paths whose every nominated scan launch is kept (inputs and
        #: outputs) to be held against the plain versions after the drain
        self.nom_paths = ("nominated", "preemption")
        #: (path, (node_cfg, usage, pod batch, nom), packed, new usage)
        self.nom_launches = []
        #: while a list: every price_nodes call's (inputs, outputs)
        self.price_log = None
        #: the kernel storm's price_nodes calls (price_log of that run)
        self.storm_price = []
        #: the inputs of the largest drf_dominant / drf_order call (the
        #: last one at that size, when shares have built up)
        self.dominant_inputs = None
        self.order_inputs = None
        #: variant -> its first batch's (node_cfg, usage, pod batch, nom)
        self.scan_inputs = {}
        self.variant = None
        self.dirty_inputs = None    # largest apply_dirty call's inputs
        #: (variant, start event, end event) around every device call
        self.events = []
        self._orig = {}

    def __enter__(self):
        kb = self.kb
        self._orig = {"schedule_batch_packed": kb.schedule_batch_packed,
                      "apply_dirty": kb.apply_dirty}
        orig_scan, orig_dirty = (self._orig["schedule_batch_packed"],
                                 self._orig["apply_dirty"])

        def clone(d):
            return None if d is None else {k: v.clone() for k, v in d.items()}

        def timed(fn, *args):
            import torch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.events.append((self.variant, a, b))
            return out

        def scan(node_cfg, usage, pod_batch, nom=None):
            inputs = None
            if self.variant not in self.scan_inputs or (
                    nom is not None and self.variant in self.nom_paths):
                inputs = (clone(node_cfg), clone(usage), clone(pod_batch),
                          clone(nom))
            if self.variant not in self.scan_inputs:
                self.scan_inputs[self.variant] = inputs
            packed, new_usage = timed(orig_scan, node_cfg, usage, pod_batch,
                                      nom)
            if nom is not None and self.variant in self.nom_paths:
                self.nom_launches.append((self.variant, inputs,
                                          packed.clone(), clone(new_usage)))
            return packed, new_usage

        def dirty(node_cfg, usage, idx, cfg_rows, usage_rows):
            if self.dirty_inputs is None or \
                    idx.shape[0] > self.dirty_inputs[2].shape[0]:
                self.dirty_inputs = (clone(node_cfg), clone(usage),
                                     idx.clone(), clone(cfg_rows),
                                     clone(usage_rows))
            return timed(orig_dirty, node_cfg, usage, idx, cfg_rows,
                         usage_rows)
        kb.schedule_batch_packed = scan
        kb.apply_dirty = dirty
        tk = self.tk
        self._orig_tk = {"drf_dominant": tk.drf_dominant,
                         "drf_order": tk.drf_order}
        orig_dom, orig_ord = tk.drf_dominant, tk.drf_order

        def dominant(usage, cap):
            if self.dominant_inputs is None or \
                    usage.shape[0] >= self.dominant_inputs[0].shape[0]:
                self.dominant_inputs = (usage.clone(), cap.clone())
            return timed(orig_dom, usage, cap)

        def order(prio, shares, tidx, pos):
            if self.order_inputs is None or \
                    prio.shape[0] >= self.order_inputs[0].shape[0]:
                self.order_inputs = (prio.clone(), shares.clone(),
                                     tidx.clone(), pos.clone())
            return timed(orig_ord, prio, shares, tidx, pos)
        tk.drf_dominant = dominant
        tk.drf_order = order
        pk = self.pk
        self._orig_pk = pk.price_nodes
        orig_price = pk.price_nodes

        def price(*args):
            out = timed(orig_price, *args)
            if self.price_log is not None:
                self.price_log.append((tuple(a.clone() for a in args),
                                       tuple(o.clone() for o in out)))
            return out
        pk.price_nodes = price
        gk = self.gk
        self._orig_gang = (gk.gang_schedule_packed, pk.price_domains,
                           pk.build_domain_tables)
        orig_gang, orig_price_dom, orig_tabs = self._orig_gang

        def gang(node_cfg, usage, pod_batch, gang_tab, nom=None,
                 exempt_mates=False):
            has_cap = all(k in gang_tab for k in gk.CAP_KEYS)
            name = gk.gang_instance(has_cap,
                                    pod_batch.get("soft_dom") is not None,
                                    nom is not None)
            key = (self.variant, name)
            entries = int((gang_tab["pod_idx"] >= 0).sum())
            if entries > self._gang_entries.get(key, -1):
                self._gang_entries[key] = entries
                self.gang_inputs[key] = (clone(node_cfg), clone(usage),
                                         clone(pod_batch), clone(gang_tab),
                                         clone(nom), exempt_mates)
            return timed(orig_gang, node_cfg, usage, pod_batch, gang_tab,
                         nom, exempt_mates)

        def domains(*args):
            out = timed(orig_price_dom, *args)
            if self.domain_log is not None:
                self.domain_log.append((tuple(a.clone() for a in args),
                                        tuple(o.clone() for o in out)))
            return out

        def tables(*args, **kw):
            t0 = time.perf_counter()
            out = orig_tabs(*args, **kw)
            self.domain_tables_s.append(time.perf_counter() - t0)
            return out
        gk.gang_schedule_packed = gang
        pk.price_domains = domains
        pk.build_domain_tables = tables
        sk = self.sk
        self._orig_spec = sk.schedule_batch_speculative_packed
        orig_spec = self._orig_spec

        def spec(node_cfg, usage, pod_batch, nom=None, width=16):
            return timed(orig_spec, node_cfg, usage, pod_batch, nom, width)
        sk.schedule_batch_speculative_packed = spec
        ak = self.ak
        self._orig_ak = ak._affinity_masks_cuda
        orig_masks = self._orig_ak

        def masks(*args):
            out = timed(orig_masks, *args)
            self.mask_events.append(self.events[-1])
            return out
        ak._affinity_masks_cuda = masks
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self.kb, k, v)
        for k, v in self._orig_tk.items():
            setattr(self.tk, k, v)
        self.pk.price_nodes = self._orig_pk
        (self.gk.gang_schedule_packed, self.pk.price_domains,
         self.pk.build_domain_tables) = self._orig_gang
        self.sk.schedule_batch_speculative_packed = self._orig_spec
        self.ak._affinity_masks_cuda = self._orig_ak


class PlainOnCard:
    """Patches the kernel launchers out of the drain for this script's
    comparison run, so the same tensors on the card take the plain
    PyTorch versions. The package itself has no such switch."""

    def __init__(self, port):
        self.kb, self.tk, self.pk = port.kb, port.tk, port.pk
        self.gk, self.sk, self.ak = port.gk, port.sk, port.ak
        self._orig = []

    def __enter__(self):
        kb, tk, pk, gk, sk = self.kb, self.tk, self.pk, self.gk, self.sk
        ak = self.ak
        for mod, name, plain in (
                (ak, "_affinity_masks_cuda", ak.affinity_masks_plain),
                (ak, "_affinity_scores_cuda", ak.affinity_scores_plain),
                (kb, "class_ms_init", kb.class_ms_init_plain),
                (kb, "_class_scan_cuda", kb._class_scan_plain),
                (kb, "_pod_scan_cuda", kb._pod_scan_plain),
                (kb, "apply_dirty", kb.apply_dirty_plain),
                (tk, "drf_dominant", tk.drf_dominant_plain),
                (tk, "drf_order", tk.drf_order_plain),
                (pk, "price_nodes", pk.price_nodes_plain),
                (gk, "_gang_scan_cuda", gk.gang_schedule_plain),
                (gk, "gang_feasible", gk.gang_feasible_plain),
                (pk, "price_domains", pk.price_domains_plain),
                (sk, "_spec_scan_cuda", sk._spec_scan_plain)):
            self._orig.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        self._orig = []


class MaskRoute:
    """While the service-anti-affinity path runs: wraps
    TopologyIndex.required_masks so that each call's rows (the K13 route
    at the default DEVICE_EVAL_THRESHOLD) are held bit for bit against the
    host route (the same call with the threshold raised past it: np.stack
    of _profile_mask_row), and kernels.affinity.affinity_masks to time the
    route's host work and keep the largest call's inputs for the kernel
    phase. The wrapped calls themselves are unchanged."""

    def __init__(self, port):
        self.topo, self.ak = port.topology, port.ak
        #: one dict per required_masks call: U, T, cap, launches, route_s
        #: (the whole call), call_s (inside affinity_masks: padding,
        #: upload, K13, download), check_s (the host route), equal
        self.calls = []
        #: the (has_dom, present, sel_dom, sel_present, sel_absent) of the
        #: affinity_masks call with the largest U·T
        self.largest = None
        self._cur = None

    def __enter__(self):
        topo, ak = self.topo, self.ak
        self._orig = (topo.TopologyIndex.required_masks, ak.affinity_masks)
        orig_rm, orig_am = self._orig

        def affinity_masks(*args, **kw):
            cur = self._cur
            n0 = ak.LAUNCHES["affinity_masks"]
            t0 = time.perf_counter()
            out = orig_am(*args, **kw)
            cur["call_s"] += time.perf_counter() - t0
            cur["launches"] += ak.LAUNCHES["affinity_masks"] - n0
            cur["T"] = args[0].shape[0]
            size = args[0].shape[0] * args[2].shape[0]
            if self.largest is None or \
                    size > self.largest[0].shape[0] * self.largest[2].shape[0]:
                self.largest = args[:5]
            return out

        def required_masks(index, profiles):
            cur = {"U": len(profiles), "T": 0,
                   "cap": index.mirror.t.capacity, "launches": 0,
                   "call_s": 0.0}
            self._cur = cur
            t0 = time.perf_counter()
            rows = orig_rm(index, profiles)
            cur["route_s"] = time.perf_counter() - t0
            saved = topo.DEVICE_EVAL_THRESHOLD
            topo.DEVICE_EVAL_THRESHOLD = float("inf")
            try:
                t0 = time.perf_counter()
                host = orig_rm(index, profiles)
                cur["check_s"] = time.perf_counter() - t0
            finally:
                topo.DEVICE_EVAL_THRESHOLD = saved
            cur["equal"] = rows.shape == host.shape and \
                bool((rows == host).all())
            self.calls.append(cur)
            return rows
        topo.TopologyIndex.required_masks = required_masks
        ak.affinity_masks = affinity_masks
        return self

    def __exit__(self, *exc):
        self.topo.TopologyIndex.required_masks, self.ak.affinity_masks = \
            self._orig


class FirstScan:
    """While a drain runs with the plain versions on the card: keeps its
    first kb.schedule_batch_packed call in rec.plain_first[path] (a copy
    of the inputs, the outputs, the host ms of the call), so that the
    kernel phase holds K2 against it instead of running the plain
    versions on the same batch again."""

    def __init__(self, port, rec, path):
        self.torch, self.kb, self.rec, self.path = port.torch, port.kb, \
            rec, path

    def __enter__(self):
        torch, kb, rec, path = self.torch, self.kb, self.rec, self.path
        self._orig = orig = kb.schedule_batch_packed

        def clone(d):
            return None if d is None else {k: v.clone() for k, v in d.items()}

        def scan(node_cfg, usage, pod_batch, nom=None):
            if path in rec.plain_first:
                return orig(node_cfg, usage, pod_batch, nom)
            inputs = (clone(node_cfg), clone(usage), clone(pod_batch),
                      clone(nom))
            ms, (packed, new_usage) = time_host(
                torch, lambda: orig(node_cfg, usage, pod_batch, nom))
            rec.plain_first[path] = (inputs, packed.clone(),
                                     clone(new_usage), ms)
            return packed, new_usage
        kb.schedule_batch_packed = scan
        return self

    def __exit__(self, *exc):
        self.kb.schedule_batch_packed = self._orig


def run_scheduler_drain(port, device, n_nodes, n_pods, batch,
                        variant="tenants", speculative=None):
    """The scheduler loop on `device`, built as bench.py's run_config
    builds it: nodes and pods created through the port's Client, nodes
    and the variant's seeded bound pods fed to the cache, pods (features
    precomputed, as the informer thread does) to the queue; bench.py's
    compile warm-up batches are left out (nothing here compiles per
    shape). `variant` "tenants" is the nine-tenant mix, any other a
    bench.py pod variant (`nominated` installs its ghost nominations, as
    bench.py's _install_variant_extras does); `speculative` is the
    Scheduler's argument (True: the speculative cohort route). Returns the drain's
    numbers; host phases and
    the launch-to-committed latency of each batch are taken by wrapping
    the drain's own methods here (the package has no such hooks)."""
    client = port.Client(validate=False)
    sched = port.Scheduler(client, batch_size=batch, device=device,
                           speculative=speculative)
    t0 = time.perf_counter()
    for i in range(n_nodes):
        node = port.wl.make_node(port.api, i)
        client.nodes().create(node)
        sched.cache.add_node(node)
    seeds = port.wl.seed_pods(port.api, variant, n_nodes)
    for pod in seeds:
        sched.cache.add_pod(pod)
    if variant == "nominated":
        port.wl.install_nominated(port.api, sched.queue.nominated, n_nodes)
    make = port.tenant_pod if variant == "tenants" else \
        (lambda i: port.wl.make_pod(port.api, i, variant))
    pods = [client.pods().create(make(i)) for i in range(n_pods)]
    for pod in pods:
        port.precompute(pod)
        sched.queue.add(pod)
    setup_s = time.perf_counter() - t0
    sched.algorithm.refresh()
    phases, latency = instrument(sched)
    t0 = time.perf_counter()
    n = sched.drain_pipelined()
    wall = time.perf_counter() - t0
    sched.stop()
    stored = client.pods().list()
    return {"sched": sched, "client": client, "pods": stored, "bound": n,
            "seeds": seeds,
            "binds": {p.metadata.key(): p.spec.node_name or None
                      for p in stored},
            "wall": wall, "setup_s": setup_s, "latency": latency,
            "phases": phases, "commit_thread": sched._commit_async,
            "phase_stats": dict(sched.algorithm.phase_stats)}


def instrument(sched):
    """(phases, latency): host seconds of the drain's phases and the
    launch-to-committed latency of each batch, taken by wrapping the
    drain's own methods here (the package has no such hooks)."""
    phases = {"drf_order": 0.0, "launch": 0.0, "finish": 0.0,
              "commit": 0.0}
    latency = []
    algo = sched.algorithm

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                phases[name] += time.perf_counter() - t
        return run
    sched._drf_order = timed("drf_order", sched._drf_order)
    sched._commit_stage = timed("commit", sched._commit_stage)
    algo.schedule_finish = timed("finish", algo.schedule_finish)
    launch = timed("launch", algo.schedule_launch)

    def schedule_launch(*a, **kw):
        t = time.perf_counter()
        pending = launch(*a, **kw)
        if pending is not None:
            pending.t_launch = t
        return pending
    algo.schedule_launch = schedule_launch
    finish_pipelined = sched._finish_pipelined

    def finish(pending, cycle, commit_fut):
        fut = finish_pipelined(pending, cycle, commit_fut)
        if fut is None:
            latency.append(time.perf_counter() - pending.t_launch)
        else:
            fut.add_done_callback(lambda f, t=pending.t_launch:
                                  latency.append(time.perf_counter() - t))
        return fut
    sched._finish_pipelined = finish
    algo.reset_phase_stats()
    return phases, latency


def run_gang_drain(port, device, n_nodes, n_pods, slice_gangs, plain_gangs,
                   batch):
    """BASELINE.json config 5 (workload.gang_objects) through the port's
    Client: nodes, PodGroups and pods created, then the Scheduler's
    informers listed and fed on this thread (workload.InformerPump) and
    Scheduler.drain_pipelined driven until nothing is pending
    (workload.drain_until_idle, a FakeClock stepped past backoffs)."""
    api, wl = port.api, port.wl
    nodes, groups, pods = wl.gang_objects(api, n_nodes, n_pods, slice_gangs,
                                          plain_gangs)
    t0 = time.perf_counter()
    clock = port.FakeClock()
    client = port.Client(validate=False)
    for node in nodes:
        client.nodes().create(node)
    for g in groups:
        client.pod_groups("default").create(g)
    for pod in pods:
        client.pods().create(pod)
    sched = port.Scheduler(client, batch_size=batch, device=device,
                           clock=clock)
    pump = wl.InformerPump(sched.informers)
    setup_s = time.perf_counter() - t0
    sched.algorithm.refresh()
    phases, latency = instrument(sched)
    t0 = time.perf_counter()
    try:
        bound = wl.drain_until_idle(sched, pump, clock)
    finally:
        pump.close()
    wall = time.perf_counter() - t0
    sched.stop()
    stored = client.pods().list()
    return {"sched": sched, "pods": stored, "bound": bound, "groups": groups,
            "binds": {p.metadata.key(): p.spec.node_name or None
                      for p in stored},
            "wall": wall, "setup_s": setup_s, "latency": latency,
            "phases": phases, "commit_thread": sched._commit_async,
            "phase_stats": dict(sched.algorithm.phase_stats),
            "gangs": (sched.gang_metrics.gangs_admitted.value(),
                      sched.gang_metrics.gangs_rejected.value())}


def check_gangs(port, label, n_nodes, pods, binds, groups):
    """Every PodGroup bound whole (all members or none, and here all),
    every gang with a topology key inside one of its domains."""
    lab = port.api.wellknown.LABEL_POD_GROUP
    members = {}
    for pod in pods:
        g = pod.metadata.labels.get(lab)
        if g:
            members.setdefault(g, []).append(binds[pod.metadata.key()])
    slice_of = {port.wl.slice_node(port.api, i).metadata.name:
                f"s{i // port.wl.SLICE_NODES}" for i in range(n_nodes)}
    for g in groups:
        nodes = members.get(g.metadata.name, [])
        placed = [n for n in nodes if n]
        if len(nodes) < g.spec.min_member or len(placed) != len(nodes):
            fail(f"{label}: PodGroup {g.metadata.name} bound {len(placed)} "
                 f"of {len(nodes)} members (minMember "
                 f"{g.spec.min_member})")
        if g.spec.topology_key and len({slice_of[n] for n in placed}) != 1:
            fail(f"{label}: PodGroup {g.metadata.name} spans slices "
                 f"{sorted({slice_of[n] for n in placed})}")


def run_gang_storm(port, device, n_nodes, repeats, keyless):
    """bench.py preempt_main's gang_preempt: the storm cluster straight
    into a cache, `keyless` BatchScheduler.preempt_gang calls for a gang
    of 8 with no topology key (the whole cluster one domain), then
    `repeats` for one gang of 8 on tpu/slice (workload.storm_gang), the
    cache left as it is between them (the bench's repeated decision)."""
    cache, pdbs = port.wl.storm_cache(port.api, port.Cache, n_nodes)
    sched = port.BatchScheduler(cache, pdb_lister=lambda: pdbs,
                                device=device)

    def plans_of(members, key, n):
        out = []
        t0 = time.perf_counter()
        for _ in range(n):
            plan = sched.preempt_gang(members, 8, key)
            out.append(None if plan is None else (
                plan.domain, [v.metadata.key() for v in plan.victims],
                [(m.metadata.key(), n) for m, n in plan.nominations],
                plan.num_pdb_violations))
        return out, time.perf_counter() - t0
    _, free = port.wl.storm_gang(port.api, 1, topology_key="")
    keyless_plans, keyless_s = plans_of(free, "", keyless)
    _, members = port.wl.storm_gang(port.api, 0)
    plans, elapsed = plans_of(members, port.wl.STORM_SLICE, repeats)
    return {"plans": plans, "elapsed": elapsed,
            "keyless_plans": keyless_plans, "keyless_s": keyless_s}


def run_gang_preemption(port, device, n_nodes, n_gangs, batch):
    """The storm cluster through the port's Client (nodes, bound victims,
    the PDB object), then `n_gangs` gangs of 8 (workload.storm_gang)
    arriving one after another, each drained until nothing is pending
    (workload.drain_until_idle) before the next is created."""
    clock = port.FakeClock()
    client = port.Client(validate=False)
    t0 = time.perf_counter()
    victims = port.wl.storm_client(port.api, client, n_nodes)
    sched = port.Scheduler(client, batch_size=batch, device=device,
                           clock=clock)
    pump = port.wl.InformerPump(sched.informers)
    setup_s = time.perf_counter() - t0
    algo = sched.algorithm
    plans = []
    preempt_gang = algo.preempt_gang

    def counted(members, mm, tk):
        plan = preempt_gang(members, mm, tk)
        if plan is not None:
            plans.append(plan.domain)
        return plan
    algo.preempt_gang = counted
    bound = 0
    groups = []
    t0 = time.perf_counter()
    try:
        for g in range(n_gangs):
            group, members = port.wl.storm_gang(port.api, g)
            groups.append(group)
            client.pod_groups("default").create(group)
            for m in members:
                client.pods().create(m)
            pump.pump()
            bound += port.wl.drain_until_idle(sched, pump, clock)
    finally:
        del algo.preempt_gang
        pump.close()
    wall = time.perf_counter() - t0
    sched.stop()
    pods = {p.metadata.key(): p for p in client.pods().list()}
    return {"sched": sched, "bound": bound, "wall": wall,
            "setup_s": setup_s, "plans": plans, "groups": groups,
            "victims": victims, "pods": pods,
            "binds": {k: p.spec.node_name or None for k, p in pods.items()},
            "evicted": sorted(v.metadata.key() for v in victims
                              if v.metadata.key() not in pods),
            "nominated": {k: p.status.nominated_node_name
                          for k, p in pods.items()
                          if p.metadata.name.startswith("gang")},
            "attempts": sched.metrics.preemption_attempts.value(),
            "evictions": sched.metrics.preemption_victims.value()}


def check_gang_preemption(port, label, r, n_nodes, n_gangs):
    """Every gang bound whole inside one slice, every evicted victim below
    the gangs' priority, a victim PodGroup evicted whole or not at all,
    no node over capacity, preemption_attempts equal to the plans made."""
    gangs = {k: p for k, p in r["pods"].items()
             if p.metadata.name.startswith("gang")}
    if len(gangs) != 8 * n_gangs or r["bound"] != 8 * n_gangs:
        fail(f"{label}: {r['bound']} of {8 * n_gangs} gang members bound")
    pods = list(r["pods"].values())
    check_gangs(port, label, n_nodes, list(gangs.values()),
                {k: p.spec.node_name for k, p in gangs.items()},
                r["groups"])
    prio = {v.metadata.key(): v.spec.priority for v in r["victims"]}
    above = [k for k in r["evicted"] if prio[k] >= PREEMPTOR_PRIORITY]
    if above:
        fail(f"{label}: evicted victims at or above the gangs' priority: "
             f"{above[:5]}")
    if not r["evicted"]:
        fail(f"{label}: no victim was evicted")
    lab = port.api.wellknown.LABEL_POD_GROUP
    evicted = set(r["evicted"])
    vgroups = {}
    for v in r["victims"]:
        g = v.metadata.labels.get(lab)
        if g:
            vgroups.setdefault(g, []).append(v.metadata.key() in evicted)
    split = [g for g, e in vgroups.items() if any(e) and not all(e)]
    if split:
        fail(f"{label}: victim PodGroups evicted in part: {split[:5]}")
    check_capacity(port, label, n_nodes, pods,
                   {p.metadata.key(): p.spec.node_name for p in pods})
    if r["attempts"] != len(r["plans"]):
        fail(f"{label}: preemption_attempts {r['attempts']} != "
             f"{len(r['plans'])} plans made")


def run_drain(port, variant, device, n_nodes, n_pods, batch, chain,
              speculative=False):
    """The stand-in drain (scheduler/drain.py) over bench.py's variant;
    `speculative` turns the BatchScheduler's speculative route and its
    divergence oracle on."""
    sched, cache = port.scheduler(n_nodes, variant, device)
    sched.speculative = sched.spec_oracle = speculative
    pods = port.pods(n_pods, variant)
    t0 = time.perf_counter()
    res = port.drain(sched, pods, batch, chain=chain)
    wall = time.perf_counter() - t0
    return sched, pods, res, wall


def check_capacity(port, variant, n_nodes, pods, binds, reserved=()):
    """Every pod bound, and per node the recomputed requests (cpu,
    memory, pod count) within allocatable, counting `reserved` (pod,
    node) pairs as if bound there (the nominated path's ghosts)."""
    unbound = [k for k, v in binds.items() if v is None]
    if len(binds) != len(pods) or unbound:
        fail(f"{variant}: {len(pods) - len(binds) + len(unbound)} of "
             f"{len(pods)} pods did not bind")
    alloc = {}
    for i in range(n_nodes):
        node = port.wl.make_node(port.api, i, variant)
        alloc[node.metadata.name] = port.NodeInfo(node).allocatable
    used = {}
    for pod, node in [(p, binds[p.metadata.key()]) for p in pods] + \
            list(reserved):
        r = port.pod_resource(pod)
        u = used.setdefault(node, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for node, (cpu, mem, cnt) in used.items():
        a = alloc[node]
        if cpu > a.milli_cpu or mem > a.memory or \
                cnt > a.allowed_pod_number:
            fail(f"{variant}: node {node} over capacity: cpu {cpu}/"
                 f"{a.milli_cpu}, memory {mem}/{a.memory}, pods {cnt}/"
                 f"{a.allowed_pod_number}")


def check_affinity_drain(port, path, r):
    """Every pod bound in the store, capacity held with the seeded pods
    (and on the nominated variant the ghost reservations) counted, and on
    the pod-anti-affinity variant no two pods of a color (seeds included)
    on one node; the same gates for a path's classic run."""
    variant, n_nodes, n_pods = {**SCHED_PATHS, **CLASSIC_SCHED, **SVC_PATHS,
                                **{k: v[:3] for k, v in
                                   SPEC_SCHED.items()}}[path]
    if r["bound"] != n_pods:
        fail(f"{path}: drain_pipelined bound {r['bound']} of {n_pods}")
    binds = dict(r["binds"])
    binds.update({p.metadata.key(): p.spec.node_name for p in r["seeds"]})
    pods = list(r["pods"]) + list(r["seeds"])
    ghosts = [(g, node) for node, gs in
              r["sched"].queue.nominated.by_node().items() for g in gs]
    if variant == "nominated" and len(ghosts) != n_nodes // 4:
        fail(f"{path}: {len(ghosts)} ghost reservations, not "
             f"{n_nodes // 4}")
    check_capacity(port, path, n_nodes, pods, binds, reserved=ghosts)
    group = {"pod-anti-affinity": "color",
             "service-anti-affinity": "app"}.get(variant)
    if group is not None:
        seen = {}
        for pod in pods:
            key = (pod.metadata.labels[group], binds[pod.metadata.key()])
            if key in seen:
                fail(f"{path}: {seen[key]} and {pod.metadata.key()} "
                     f"of {group} {key[0]} share node {key[1]}")
            seen[key] = pod.metadata.key()


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


# ------------------------------------------------------------- timing


def time_cuda(torch, fn, reps, warm=1):
    """Mean ms of fn() over reps launches, by CUDA events after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_host(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_, ops):
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs(torch, a, b):
    if a.dtype == torch.bool or a.dtype == torch.int32:
        return 0.0 if torch.equal(a, b) else float("inf")
    return float((a.double() - b.double()).abs().max().item()) \
        if a.numel() else 0.0


def bits_equal(torch, a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def same_inputs(torch, a, b):
    """Two recorded scan inputs (node_cfg, usage, pod batch, nom) equal
    key for key, bit for bit."""
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is not None and (set(x) != set(y) or not all(
                x[k].shape == y[k].shape and x[k].dtype == y[k].dtype
                and bits_equal(torch, x[k], y[k]) for k in x)):
            return False
    return True


def check_scan(port, node_cfg, usage, pb, label, nom=None, packed_k=None,
               use_k=None, kernel="K2 class_scan", plain=None):
    """K1 + K2 (or, for a batch without class tables, K7) against their
    plain versions on one whole batch's inputs (the kernels' outputs are
    computed here unless given, the plain versions' unless `plain` gives
    (packed, post-batch usage, ms) of a run on the same inputs); returns
    (packed, post-batch usage, max abs error, ms of the plain versions on
    the card, host clock)."""
    torch, kb = port.torch, port.kb
    if packed_k is None:
        packed_k, use_k = kb.schedule_batch_packed(node_cfg, usage, pb, nom)
    if plain is not None:
        packed_p, use_p, plain_ms = plain
    else:
        with PlainOnCard(port):
            plain_ms, (packed_p, use_p) = time_host(
                torch, lambda: kb.schedule_batch_packed(node_cfg, usage, pb,
                                                        nom))
    torch.cuda.synchronize()
    if not torch.equal(packed_k, packed_p):
        fail(f"{kernel} disagrees with its plain version on the "
             f"{label} batch ({int((packed_k != packed_p).sum())} packed "
             "entries)")
    if set(use_k) != set(use_p):
        fail(f"{kernel} post-batch usage keys differ on the {label} batch")
    for k in use_p:
        if not bits_equal(torch, use_k[k], use_p[k]):
            fail(f"{kernel} post-batch usage {k} disagrees on the "
                 f"{label} batch")
    err = max(max_abs(torch, packed_k[0], packed_p[0]),
              max_abs(torch, packed_k[1].view(torch.float32),
                      packed_p[1].view(torch.float32)),
              *(max_abs(torch, use_k[k], use_p[k]) for k in use_p))
    return packed_k, use_k, err, plain_ms


def kernel_phase(port, rec, route, launches):
    torch, kb = port.torch, port.kb
    node_cfg, usage, pb, _ = rec.scan_inputs["uniform"]
    cls = {k: pb[k] for k in kb._CLASS_KEYS}
    rw, um, us = pb["resource_weights"], pb["unique_masks"], \
        pb["unique_scores"]
    N, R = node_cfg["alloc"].shape
    C = cls["class_req"].shape[0]
    rows = []

    # ---- K1 class_ms_init
    ms_k = kb.class_ms_init(node_cfg, usage, cls, um, us, rw)
    ms_p = kb.class_ms_init_plain(node_cfg, usage, cls, um, us, rw)
    torch.cuda.synchronize()
    if not bits_equal(torch, ms_k, ms_p):
        fail("K1 class_ms_init disagrees with its plain version")
    k1_ms = time_cuda(torch, lambda: kb.class_ms_init(
        node_cfg, usage, cls, um, us, rw), reps=50, warm=3)
    k1_plain_ms, _ = time_host(torch, lambda: kb.class_ms_init_plain(
        node_cfg, usage, cls, um, us, rw))
    k1_bytes = nbytes(*node_cfg.values(), *usage.values(), *cls.values(),
                      rw, ms_k) + um.numel() + us.numel() * 4
    # per (class, node): R adds + R compares, 2 nz adds, ~24 score ops
    k1_ops = C * N * (2 * R + 28)
    k1_bound = bound(k1_bytes, k1_ops)
    rows.append({"name": "class_ms_init", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/class_ms_init.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/batch.py:327",
                 "launches": launches["class_ms_init"],
                 "max_abs_err": max_abs(torch, ms_k, ms_p),
                 "ms": k1_ms, "plain_ms": k1_plain_ms,
                 "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                 "library_ms": None, "match": True,
                 "bytes": k1_bytes, "ops": k1_ops,
                 "shape": f"C={C} N={N} R={R}"})

    # ---- K2, one row per instance: K1 + K2 held against the plain
    # versions on a whole batch of the instance's path (the plain time is
    # that run's), K2 alone timed on a freshly prepared table and carry
    k2_ms = {}
    for name, path, line in SCAN_ROWS:
        rows.append(scan_row(port, rec, launches, name, path, line))
        k2_ms[path] = rows[-1]["ms"]
    # ---- K7, one row per instance, replayed on the same batches
    for name, path, line in POD_SCAN_ROWS:
        rows.append(pod_scan_row(port, rec, launches, name, path, line))
    # ---- K12, one row per instance, replayed on the same batches
    for name, path in SPEC_ROWS:
        rows.append(spec_row(port, rec, launches, name, path, k2_ms[path]))
    # ---- K8 on the uniform and spread batches
    rows.extend(filter_rows(port, rec, launches))
    # ---- K3 apply_dirty
    if rec.dirty_inputs is None:
        fail("the main path never scattered dirty rows (K3)")
    cfg0, use0, idx, cfg_rows, use_rows = rec.dirty_inputs

    def fresh():
        return ({k: v.clone() for k, v in cfg0.items()},
                {k: v.clone() for k, v in use0.items()})
    ck, uk = kb.apply_dirty(*fresh(), idx, cfg_rows, use_rows)
    cp_, up_ = kb.apply_dirty_plain(*fresh(), idx, cfg_rows, use_rows)
    torch.cuda.synchronize()
    for k in ck:
        if not bits_equal(torch, ck[k], cp_[k]):
            fail(f"K3 apply_dirty disagrees on {k}")
    for k in uk:
        if not bits_equal(torch, uk[k], up_[k]):
            fail(f"K3 apply_dirty disagrees on {k}")
    tables = fresh()
    k3_ms = time_cuda(torch, lambda: kb.apply_dirty(
        tables[0], tables[1], idx, cfg_rows, use_rows), reps=50, warm=3)
    k3_plain_ms, _ = time_host(torch, lambda: kb.apply_dirty_plain(
        tables[0], tables[1], idx, cfg_rows, use_rows))
    cap = next(iter(cfg0.values())).shape[0]
    keep = (idx >= 0) & (idx < cap)
    live = idx[keep].long()
    lib_src = {k: v[keep] for k, v in {**cfg_rows, **use_rows}.items()}
    lib_dst = {**tables[0], **tables[1]}

    def library():
        for k, t in lib_dst.items():
            t.index_copy_(0, live, lib_src[k])
    k3_lib_ms = time_cuda(torch, library, reps=50, warm=3)
    D = idx.shape[0]
    n_live = int(keep.sum())
    row_bytes = sum(t.element_size() * (t.numel() // t.shape[0])
                    for t in lib_dst.values())
    k3_bytes = D * 4 + 2 * n_live * row_bytes
    k3_bound = bound(k3_bytes, 0)
    rows.append({"name": "apply_dirty", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/apply_dirty.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/batch.py:1146",
                 "launches": launches["apply_dirty"], "max_abs_err": 0.0,
                 "ms": k3_ms, "plain_ms": k3_plain_ms,
                 "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
                 "library_ms": k3_lib_ms, "match": True,
                 "library_call": f"index_copy_ x{len(lib_dst)} tables",
                 "bytes": k3_bytes, "ops": 0,
                 "shape": f"D={D} ({n_live} rows) N={cap}"})
    rows.extend(drf_rows(port, rec, launches))
    rows.append(price_row(port, rec, launches))
    # ---- K9 per instance, the singleton replay against K7, K10, K11
    for name, path in GANG_ROWS:
        rows.append(gang_row(port, rec, launches, name, path))
    rows[-2]["singleton_replay_equals_k7"] = gang_singleton_replay(port,
                                                                   rec)
    rows[-1]["mates_replay"] = gang_mates_replay(port, rec)
    rows.append(feasible_row(port, rec, launches))
    rows.append(domains_row(port, rec, launches))
    rows.extend(affinity_rows(port, route, launches))
    return rows


def scan_row(port, rec, launches, name, path, line):
    torch, kb = port.torch, port.kb
    if path not in rec.scan_inputs:
        fail(f"the {path} path never reached the class scan")
    node_cfg, usage, pb, nom = rec.scan_inputs[path]
    spread, topo, dir2, soft = kb._scan_terms(pb)
    runs_name = kb.scan_instance(spread, topo, soft, nom is not None)
    if runs_name != name:
        fail(f"the {path} batch runs {runs_name}, not {name}")
    plain = rec.plain_first.get(path)
    if plain is not None and \
            not same_inputs(torch, plain[0], rec.scan_inputs[path]):
        print(f"{name}: the plain drain's first {path} batch differs from "
              "the recorded one; the plain versions run again")
        plain = None
    packed_k, use_k, err, plain_ms = check_scan(
        port, node_cfg, usage, pb, path, nom,
        plain=None if plain is None else plain[1:])
    rec.k2_out[path] = (packed_k, use_k)
    cls = {k: pb[k] for k in kb._CLASS_KEYS}
    rw = pb["resource_weights"]

    def scan_only():
        # a fresh table and carry for each run; only the scan is timed
        _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage, pb, nom)
        return lambda: kb._class_scan_cuda(node_cfg, pb, cls, rw, ms0,
                                           carry, terms, nom)
    runs = [time_cuda(torch, scan_only(), reps=1, warm=0) for _ in range(3)]
    ms = sum(runs[1:]) / 2   # the first run pays the library load
    c = scan_costs(kb, node_cfg, usage, pb, nom, packed_k, use_k)
    ops = c["P"] * (c["N"] * c["per_node"] + c["per_pod"]) + c["term_ops"]
    b = bound(c["bytes"], ops)
    return {"name": name, "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/class_scan.cu"
                      " + class_step.cuh"
                      + (" + affinity.cuh" if topo or soft else ""),
            "replaces": f"kubernetes_tpu/scheduler/kernels/{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "match": True,
            "plain_from": "run again" if plain is None
                          else "the first batch of its plain drain",
            "bytes": c["bytes"], "ops": ops,
            "shape": c["shape"] + f" ({path} batch)"}


def scan_costs(kb, node_cfg, usage, pb, nom, packed, use_out):
    """The work of K2's serial step on one batch, as scan_row and
    spec_row count it: bytes (each input read once and each output
    written once, the [C, N] table read and written once), ops per (pod,
    node) and per pod, the ops that depend on the data (carried terms,
    the nominees' own rows), the sizes and a shape string."""
    N, R = node_cfg["alloc"].shape
    cls = {k: pb[k] for k in kb._CLASS_KEYS}
    C = cls["class_req"].shape[0]
    P = pb["class_idx"].shape[0]
    bytes_ = (nbytes(*node_cfg.values(), *usage.values(), *cls.values(),
                     pb["resource_weights"], pb["class_idx"], pb["seq"],
                     pb["active"], packed, *use_out.values(),
                     pb["unique_masks"], pb["unique_scores"]) + 2 * C * N * 4)
    # per (pod, node): feasibility compare, select, tie penalty mul + sub,
    # argmax compare; per pod the winner column over C classes and the
    # usage adds
    t_bytes, t_node, t_pod, term_ops, (G, K, Ks) = term_cost(kb, pb, usage,
                                                              N)
    bytes_ += t_bytes
    per_node = 5 + t_node
    per_pod = C * (2 * R + 28) + R + 3 + t_pod
    selfs = 0
    if nom is not None:
        bytes_ += nbytes(*nom.values(), pb["nom_row"])
        # the winner column's R + 1 reservation adds per pod; each
        # nominee's own row: 2R + 2 folds and one class score
        selfs = int((pb["nom_row"] >= 0).sum())
        per_pod += R + 1
        term_ops += selfs * (2 * R + 30)
    dir2 = "cmatch_tids" in pb
    return {"bytes": bytes_, "per_node": per_node, "per_pod": per_pod,
            "term_ops": term_ops, "N": N, "R": R, "C": C, "P": P,
            "shape": f"P={P} C={C} N={N} R={R} G={G} K={K} Ks={Ks}"
                     f"{' dir2' if dir2 else ''}"
                     f"{f' nominees={selfs}' if nom is not None else ''}"}


def spec_plain_of(pb):
    """The batch's spec_plain as tensorize.set_speculative marks it: no
    carried-term read (required or waived (anti-)affinity lists, a spread
    group, a soft credit read) and no nomination of its own."""
    plain = pb["nom_row"] < 0
    for k in ("anti_tids", "aff_tids", "cmatch_tids"):
        if k in pb:
            plain = plain & (pb[k] < 0).all(dim=1)
    for k in ("spread_gidx", "soft_base_idx"):
        if k in pb:
            plain = plain & (pb[k] < 0)
    return plain


def prefix_batch(pb, n):
    """The batch cut to its first n pods (whole cohorts)."""
    return {k: v[:n].contiguous() if k in POD_AXIS else v
            for k, v in pb.items()}


def spec_stats(st, W, P):
    """(accepted-cohort share, repaired-pod share) of K12's stats."""
    st = st.cpu()
    collided = st[:, 0] == 0
    repaired = int((W - st[collided, 1]).sum())
    return float(st[:, 0].float().mean()), repaired / P


def hold_spec_on_k2(port, label, packed, use, packed_2, use_2, active):
    """K12 against K2 on one batch: assign, the active pods' score bits
    and every post-batch usage final. (A padding pod is never checked for
    collisions: its score is its frozen pick's, as in the JAX speculative
    kernel.) Returns the count of pads whose score bits differ."""
    torch = port.torch
    differ = (packed[0] != packed_2[0]).nonzero().flatten()
    if len(differ):
        q = int(differ[0])
        fail(f"K12 and K2 decide differently on {label}: {len(differ)} "
             f"pods, first pod {q}: K12 row {int(packed[0, q])}, K2 row "
             f"{int(packed_2[0, q])}")
    sd = packed[1] != packed_2[1]
    q = (sd & active).nonzero().flatten()
    if len(q):
        q = int(q[0])
        fail(f"K12 and K2 choose different scores on {label}: first active"
             f" pod {q}: K12 bits {int(packed[1, q])}, K2 "
             f"{int(packed_2[1, q])}")
    if set(use) != set(use_2):
        fail(f"K12 and K2 post-batch usage keys differ on {label}")
    for k in use:
        if not bits_equal(torch, use[k], use_2[k]):
            fail(f"K12 and K2 post-batch usage {k} differs on {label}")
    return int((sd & ~active).sum())


def spec_row(port, rec, launches, name, path, k2_ms):
    """K12's instance on the recorded batch of its K2 instance's path, at
    full size and the default cohort width, the contention gate forced
    open (spec_plain as set_speculative marks the batch): held against
    K2's results on that batch (hold_spec_on_k2); on a prefix of the batch
    (SPEC_PLAIN_PODS) held bit for bit, stats included, against its plain
    version on the card; K12 alone timed on a fresh table and carry, beside
    K2's time on the same batch; on the uniform batch the widths of
    SPEC_WIDTHS too."""
    torch, kb, sk = port.torch, port.kb, port.sk
    node_cfg, usage, pb0, nom = rec.scan_inputs[path]
    pb = dict(pb0, spec_plain=spec_plain_of(pb0))
    spread, topo, dir2, soft = kb._scan_terms(pb)
    runs_name = kb.scan_instance(spread, topo, soft, nom is not None,
                                 "spec_scan")
    if runs_name != name:
        fail(f"the {path} batch runs {runs_name}, not {name}")
    P = pb["class_idx"].shape[0]
    W = sk.cohort_width(P)
    packed_2, use_2 = rec.k2_out[path]
    label = f"the {path} batch (width {W})"
    packed, use, st = sk.schedule_batch_speculative_packed(
        node_cfg, usage, pb, nom, width=W)
    torch.cuda.synchronize()
    pads = hold_spec_on_k2(port, label, packed, use, packed_2, use_2,
                           pb["active"])
    acc, rep = spec_stats(st, W, P)
    # against the plain version on a prefix
    n = SPEC_PLAIN_PODS.get(path, SPEC_PLAIN_OTHER)
    pp = prefix_batch(pb, n)
    packed_pk, use_pk, st_pk = sk.schedule_batch_speculative_packed(
        node_cfg, usage, pp, nom, width=W)
    plain_ms, (a, sc, use_p, st_p) = time_host(
        torch, lambda: sk.schedule_batch_speculative_plain(
            node_cfg, usage, pp, nom, W))
    packed_p = kb.pack_results(a, sc)
    torch.cuda.synchronize()
    if not torch.equal(packed_pk, packed_p) or not torch.equal(st_pk, st_p):
        fail(f"K12 {name} disagrees with its plain version on the first {n}"
             f" pods of the {path} batch ({int((packed_pk != packed_p).sum())}"
             f" packed entries, stats equal: {torch.equal(st_pk, st_p)})")
    if set(use_pk) != set(use_p) or not all(
            bits_equal(torch, use_pk[k], use_p[k]) for k in use_p):
        fail(f"K12 {name} post-batch usage disagrees with its plain version"
             f" on the first {n} pods of the {path} batch")
    err = max(max_abs(torch, packed_pk[0], packed_p[0]),
              max_abs(torch, packed_pk[1].view(torch.float32),
                      packed_p[1].view(torch.float32)),
              *(max_abs(torch, use_pk[k], use_p[k]) for k in use_p))
    prefix_acc, prefix_rep = spec_stats(st_pk, W, n)
    cls = {k: pb[k] for k in kb._CLASS_KEYS}
    rw = pb["resource_weights"]

    def spec_only(batch, width):
        # a fresh table and carry for each run; only K12 is timed
        _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage, batch, nom)
        return lambda: sk._spec_scan_cuda(node_cfg, batch, cls, rw, ms0,
                                          carry, terms, nom, width)

    def timed(batch, width):
        runs = [time_cuda(torch, spec_only(batch, width), reps=1, warm=0)
                for _ in range(3)]
        return sum(runs[1:]) / 2   # the first run pays the library load
    ms = timed(pb, W)
    prefix_ms = timed(pp, W)
    widths = {}
    if path == "uniform":
        for w in SPEC_WIDTHS:
            pw, uw, sw = sk.schedule_batch_speculative_packed(
                node_cfg, usage, pb, nom, width=w)
            torch.cuda.synchronize()
            hold_spec_on_k2(port, f"the {path} batch (width {w})", pw, uw,
                            packed_2, use_2, pb["active"])
            wa, wr = spec_stats(sw, w, P)
            widths[str(w)] = {"ms": timed(pb, w), "accepted_cohorts":
                              int(sw[:, 0].sum()), "cohorts": P // w,
                              "accepted_cohort_share": wa,
                              "repaired_pod_share": wr, "equals_k2": True}
    c = scan_costs(kb, node_cfg, usage, pb, nom, packed, use)
    N, R, C = c["N"], c["R"], c["C"]
    cohorts = P // W
    repaired = rep * P
    # every pod's election (as K2's per (pod, node) base work), each
    # cohort's W winner rows and W x C columns and W^2 checks; a repaired
    # pod's serial step as K2 counts it (its share of the term ops)
    ops = int(P * N * 5 + cohorts * W * (C * (2 * R + 28) + R + 3)
              + cohorts * W * W * 4
              + repaired * (N * c["per_node"] + c["per_pod"])
              + c["term_ops"] * repaired / P)
    bytes_ = c["bytes"] + nbytes(pb["spec_plain"], st)
    b = bound(bytes_, ops)
    return {"name": name, "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/spec_scan.cu"
                      " + class_step.cuh"
                      + (" + affinity.cuh" if topo or soft else ""),
            "replaces": "kubernetes_tpu/scheduler/kernels/"
                        "speculative.py:229",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "match": True,
            "k2_ms": k2_ms, "k2_over_k12": k2_ms / ms,
            "cohort_width": W, "accepted_cohort_share": acc,
            "repaired_pod_share": rep,
            "equals_k2": "assign, active score bits, usage finals",
            "pad_score_bits_differ_from_k2": pads,
            "plain_prefix_pods": n, "prefix_ms": prefix_ms,
            "prefix_accepted_cohort_share": prefix_acc,
            "prefix_repaired_pod_share": prefix_rep,
            **({"widths": widths} if widths else {}),
            "bytes": bytes_, "ops": ops,
            "shape": c["shape"] + f" W={W} ({path} batch; plain on its "
                                  f"first {n} pods)"}


def term_cost(kb, pb, usage, N):
    """(bytes, ops per (pod, node), ops per pod, ops that depend on the
    data, (G, K, Ks)) of the carried terms a batch's scan reads: spread
    groups, topology counters, soft credits. Shared by K2's and K7's
    rows: both scans do this work alike."""
    spread, topo, _, soft = kb._scan_terms(pb)
    bytes_ = per_node = per_pod = ops = 0
    G = K = Ks = 0
    if spread:
        G = pb["spread_base"].shape[0]
        bytes_ += nbytes(pb["spread_gidx"], pb["spread_match"],
                         pb["spread_base"], pb["spread_zone"])
        per_node += 14     # reductions, node and zone scores, blend
        per_pod += G
    if topo:
        K = pb["anti_tids"].shape[1]
        lists = [pb[k] for k in ("anti_tids", "aff_tids", "match_tids",
                                 "cmatch_tids", "canti_tids") if k in pb]
        bytes_ += nbytes(pb["anti_dom"], pb["anti_cnt0"], *lists)
        # each real read entry: a domain gather, a count gather and a
        # compare at every node; each real write entry: two adds
        reads = sum(int((pb[k] >= 0).sum()) for k in
                    ("anti_tids", "aff_tids", "cmatch_tids") if k in pb)
        writes = sum(int((pb[k] >= 0).sum()) for k in
                     ("match_tids", "canti_tids") if k in pb)
        ops += 3 * reads * N + 2 * writes
    if soft:
        Ks = pb["soft_read_tids"].shape[1]
        bytes_ += nbytes(pb["soft_dom"], pb["soft_base"],
                         pb["soft_base_idx"], pb["soft_read_tids"],
                         pb["soft_read_w"], pb["soft_write_tids"],
                         pb["soft_write_w"],
                         usage.get("soft_cnt", pb["soft_cnt0"]))
        # each real read entry: two gathers, a multiply and an add at
        # every node; per scored pod and node the base add, the min/max
        # and the normalisation (sub, mul, sub, max, div, add, floor,
        # mul, add)
        reads = int((pb["soft_read_tids"] >= 0).sum())
        scored = int((pb["soft_base_idx"] >= 0).sum())
        writes = int((pb["soft_write_tids"] >= 0).sum())
        ops += 4 * reads * N + 12 * scored * N + writes
    return bytes_, per_node, per_pod, ops, (G, K, Ks)


def classic_batch(kb, pb):
    """A class-route batch without its class tables: the classic route's
    input (the per-pod rows are in every batch)."""
    return {k: v for k, v in pb.items()
            if k not in kb._CLASS_KEYS + ("class_idx",)}


def pod_scan_row(port, rec, launches, name, path, line):
    """K7's instance on the class route's batch of `path` with its class
    tables dropped: assign row for row equal to K2's on the same batch
    (and every active pod's score bits), packed results and post-batch
    usage bit for bit equal to the plain version on the card; K7 alone
    timed on a fresh carry."""
    torch, kb = port.torch, port.kb
    if path not in rec.scan_inputs:
        fail(f"the {path} path never reached the scan")
    node_cfg, usage, pb, nom = rec.scan_inputs[path]
    cpb = classic_batch(kb, pb)
    spread, topo, dir2, soft = kb._scan_terms(cpb)
    runs_name = kb.scan_instance(spread, topo, soft, nom is not None,
                                 "pod_scan")
    if runs_name != name:
        fail(f"the {path} batch runs {runs_name}, not {name}")
    packed_c, _ = kb.schedule_batch_packed(node_cfg, usage, pb, nom)
    packed_k, use_k = kb.schedule_batch_packed(node_cfg, usage, cpb, nom)
    torch.cuda.synchronize()
    differ = (packed_k[0] != packed_c[0]).nonzero().flatten()
    if len(differ):
        q = int(differ[0])
        fail(f"K7 {name} and K2 decide differently on the {path} batch: "
             f"{len(differ)} pods, first pod {q}: K7 row "
             f"{int(packed_k[0, q])} score bits {int(packed_k[1, q])}, K2 "
             f"row {int(packed_c[0, q])} score bits {int(packed_c[1, q])}")
    # the chosen score of an active pod is part of its decision; a pad's
    # (an inactive row tensorize added) is not: the class route scores it
    # as class 0, the classic route as a zero request, as in the reference
    active = cpb["active"]
    score_diff = packed_k[1] != packed_c[1]
    q = (score_diff & active).nonzero().flatten()
    if len(q):
        q = int(q[0])
        fail(f"K7 {name} and K2 choose different scores on the {path} "
             f"batch: first active pod {q}: K7 score bits "
             f"{int(packed_k[1, q])}, K2 {int(packed_c[1, q])}")
    pads = (score_diff & ~active).nonzero().flatten()
    pad_diff = [len(pads)] + ([int(pads[0]), int(packed_k[1, pads[0]]),
                               int(packed_c[1, pads[0]])] if len(pads)
                              else [])
    n_plain = min(POD_SCAN_PLAIN_PODS, cpb["seq"].shape[0])
    _, _, err, plain_ms = check_scan(port, node_cfg, usage,
                                     prefix_batch(cpb, n_plain),
                                     f"{path} classic, first {n_plain} pods",
                                     nom, kernel=f"K7 {name}")

    def scan_only():
        # a fresh carry for each run; only the scan is timed
        carry, terms = kb._carry_setup(usage, cpb)
        return lambda: kb._pod_scan_cuda(node_cfg, cpb, carry, terms, nom)
    runs = [time_cuda(torch, scan_only(), reps=1, warm=0) for _ in range(3)]
    ms = sum(runs[1:]) / 2   # the first run pays the library load
    N, R = node_cfg["alloc"].shape
    P = cpb["seq"].shape[0]
    bytes_ = nbytes(*node_cfg.values(), *usage.values(), cpb["req"],
                    cpb["nonzero_req"], cpb["mem_pressure_blocked"],
                    cpb["mask_idx"], cpb["score_idx"], cpb["seq"],
                    cpb["active"], cpb["unique_masks"], cpb["unique_scores"],
                    cpb["resource_weights"], packed_k, *use_k.values())
    t_bytes, t_node, t_pod, term_ops, (G, K, Ks) = term_cost(kb, cpb, usage,
                                                              N)
    bytes_ += t_bytes
    # per (pod, node), as the reference computes every row: R adds and R
    # compares and the count add and compare (fits), the resource score
    # (~24: 3 adds, 2 floors of a sub-mul-div, the mean, 2 fractions, the
    # balanced floor, 2 weights) and the static add, the select, the tie
    # penalty and the argmax compare; per pod the winner's R + 3 usage
    # adds (and its spread groups)
    per_node = 2 * R + 2 + 25 + 5 + t_node
    per_pod = R + 3 + t_pod
    selfs = 0
    if nom is not None:
        bytes_ += nbytes(*nom.values(), cpb["nom_row"])
        selfs = int((cpb["nom_row"] >= 0).sum())
        per_node += 2 * R + 2   # (used + nom) - self, (count + nom) - self
    ops = P * (N * per_node + per_pod) + term_ops
    b = bound(bytes_, ops)
    return {"name": name, "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/pod_scan.cu + pod.cuh"
                      + (" + affinity.cuh" if topo or soft else ""),
            "replaces": f"kubernetes_tpu/scheduler/kernels/{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "match": True,
            "assign_equals_k2": True, "active_score_bits_equal_k2": True,
            "plain_pods": n_plain,
            # [pads whose score bits differ from K2's, first pad row, its
            # K7 bits, its K2 bits]
            "pad_score_bits_differ": pad_diff,
            "bytes": bytes_, "ops": ops,
            "shape": f"P={P} N={N} R={R} G={G} K={K} Ks={Ks}"
                     f"{' dir2' if dir2 else ''}"
                     f"{f' nominees={selfs}' if nom is not None else ''}"
                     f" ({path} batch, class tables dropped; plain on its"
                     f" first {n_plain} pods)"}


def filter_rows(port, rec, launches):
    """K8 on the uniform and spread paths' first batches (16,384 pods x
    8,192 rows): fits equal and score bits equal to filter_score_plain on
    the card; timed beside it."""
    torch, kb = port.torch, port.kb
    rows = []
    for path, name in (("uniform", "filter_score"),
                       ("spread", "filter_score_spread")):
        node_cfg, usage, pb, _ = rec.scan_inputs[path]
        cpb = classic_batch(kb, pb)
        fits_k, score_k = kb.filter_score(node_cfg, usage, cpb)
        plain_ms, (fits_p, score_p) = time_host(
            torch, lambda: kb.filter_score_plain(node_cfg, usage, cpb))
        if not torch.equal(fits_k, fits_p):
            fail(f"K8 {name} fits disagree with the plain version on the "
                 f"{path} batch ({int((fits_k != fits_p).sum())} entries)")
        if not bits_equal(torch, score_k, score_p):
            fail(f"K8 {name} scores disagree with the plain version on the "
                 f"{path} batch")
        err = max_abs(torch, score_k, score_p)
        del fits_p, score_p
        ms = time_cuda(torch, lambda: kb.filter_score(node_cfg, usage, cpb),
                       reps=10, warm=2)
        N, R = node_cfg["alloc"].shape
        P = cpb["seq"].shape[0]
        spread = "spread_base" in cpb
        # inputs read once, outputs written once
        bytes_ = nbytes(*node_cfg.values(), usage["used"],
                        usage["nonzero_used"], usage["pod_count"],
                        cpb["req"], cpb["nonzero_req"],
                        cpb["mem_pressure_blocked"], cpb["mask_idx"],
                        cpb["score_idx"], cpb["unique_masks"],
                        cpb["unique_scores"], cpb["resource_weights"],
                        fits_k, score_k)
        # per (pod, node): fits 2R + 2, score ~25, the select; with spread
        # the two passes' reductions and the node and zone scores (~14)
        per_node = 2 * R + 2 + 25 + 1
        if spread:
            bytes_ += nbytes(cpb["spread_gidx"], cpb["spread_base"],
                             cpb["spread_zone"], cpb["spread_zinit"])
            per_node += 14
        ops = P * N * per_node
        b = bound(bytes_, ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "kubernetes_tpu_torch/csrc/filter_score.cu"
                               " + pod.cuh",
                     "replaces":
                         "kubernetes_tpu/scheduler/kernels/batch.py:220",
                     "launches": launches[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": None, "match": True,
                     "fits": int(fits_k.sum()),
                     "bytes": bytes_, "ops": ops,
                     "shape": f"P={P} N={N} R={R} ({path} batch)"})
        del fits_k, score_k
    return rows


def drf_rows(port, rec, launches):
    """K4 and K5 on the inputs the scheduler path gave them."""
    torch, tk = port.torch, port.tk
    if rec.dominant_inputs is None or rec.order_inputs is None:
        fail("the scheduler path never reached the DRF kernels")
    rows = []

    # ---- K4 drf_dominant
    usage, cap = rec.dominant_inputs
    T, R = usage.shape
    sh_k = tk.drf_dominant(usage, cap)
    sh_p = tk.drf_dominant_plain(usage, cap)
    torch.cuda.synchronize()
    if not bits_equal(torch, sh_k, sh_p):
        fail("K4 drf_dominant disagrees with its plain version")
    k4_ms = time_cuda(torch, lambda: tk.drf_dominant(usage, cap), reps=200,
                      warm=5)
    k4_plain_ms, _ = time_host(torch, lambda: tk.drf_dominant_plain(
        usage, cap))
    k4_lib_ms = time_cuda(torch, lambda: (
        usage / torch.clamp_min(cap, 1.0)).amax(1), reps=200, warm=5)
    k4_bytes = T * R * 4 + R * 4 + T * 4
    k4_bound = bound(k4_bytes, 2 * T * R)
    rows.append({"name": "drf_dominant", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/drf_dominant.cu",
                 "replaces": "kubernetes_tpu/tenancy/drf.py:98",
                 "launches": launches["drf_dominant"],
                 "max_abs_err": max_abs(torch, sh_k, sh_p),
                 "ms": k4_ms, "plain_ms": k4_plain_ms,
                 "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                 "library_ms": k4_lib_ms, "match": True,
                 "library_call": "(usage / clamp_min(cap, 1)).amax(1), "
                                 "one expression of three calls",
                 "bytes": k4_bytes, "ops": 2 * T * R,
                 "shape": f"T={T} R={R}"})

    # ---- K5 drf_order
    prio, shares, tidx, pos = rec.order_inputs
    P = prio.shape[0]
    perm_k = tk.drf_order(prio, shares, tidx, pos)
    perm_p = tk.drf_order_plain(prio, shares, tidx, pos)
    torch.cuda.synchronize()
    if not torch.equal(perm_k, perm_p):
        n = int((perm_k != perm_p).sum())
        fail(f"K5 drf_order disagrees with its plain version ({n} of {P}"
             " entries)")
    k5_ms = time_cuda(torch, lambda: tk.drf_order(prio, shares, tidx, pos),
                      reps=20, warm=2)
    k5_plain_ms, _ = time_host(torch, lambda: tk.drf_order_plain(
        prio, shares, tidx, pos))
    if not torch.equal(pos, torch.arange(P, dtype=torch.int32,
                                         device=pos.device)):
        fail("the drain's pop positions are not 0..P-1")
    neg = tk.neg_wrap(prio)

    def two_pass():
        # pos is 0..P-1: lexsort is two stable sorts, minor key first
        perm = torch.sort(shares[tidx.long()], stable=True).indices
        return perm[torch.sort(neg[perm], stable=True).indices]
    if not torch.equal(two_pass().to(torch.int32), perm_k):
        fail("the two-pass torch.sort yardstick disagrees with K5")
    k5_lib_ms = time_cuda(torch, two_pass, reps=20, warm=2)
    k5_bytes = 4 * P * 4 + shares.numel() * 4
    # a comparison sort of P keys needs P log2 P comparisons of three-part
    # keys; the rank-counting kernel itself does P * P of them
    k5_ops = int(3 * P * math.log2(max(P, 2)))
    k5_bound = bound(k5_bytes, k5_ops)
    rows.append({"name": "drf_order", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/drf_order.cu",
                 "replaces": "kubernetes_tpu/tenancy/drf.py:115",
                 "launches": launches["drf_order"], "max_abs_err": 0.0,
                 "ms": k5_ms, "plain_ms": k5_plain_ms,
                 "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
                 "library_ms": k5_lib_ms, "match": True,
                 "library_call": "two-pass stable torch.sort (share, then "
                                 "-prio), positions 0..P-1",
                 "bytes": k5_bytes, "ops": k5_ops,
                 "kernel_comparisons": P * P,
                 "shape": f"P={P} T={shares.numel()}"})
    return rows


def price_vectorized(torch, a):
    """price_nodes as one plain PyTorch expression (torch.cumsum and
    whole-tensor reductions, no loop over the units): the yardstick
    beside K6. Its sums run in PyTorch's own order, so it is timed, not
    held bit for bit."""
    (free0, cfree0, need, need_cnt, freed, fcnt, valid, pdb, top, psum,
     gcnt, startr, row_valid) = a
    V = valid.shape[1]
    fit0 = (free0 >= need).all(1) & (cfree0 >= need_cnt)
    elig = ((free0[:, None, :] + torch.cumsum(freed, 1)) >= need).all(2) \
        & ((cfree0[:, None] + torch.cumsum(fcnt, 1)) >= need_cnt) & valid
    kidx = elig.to(torch.int32).argmax(1)
    feasible = elig.any(1) & ~fit0 & row_valid
    chosen = valid & (torch.arange(V, device=valid.device)[None, :]
                      <= kidx[:, None]) & feasible[:, None]
    nviol = (chosen & pdb).sum(1)
    topv = torch.where(chosen, top, -2**31).amax(1)
    psumv = torch.where(chosen, psum, 0.0).sum(1)
    cntv = torch.where(chosen, gcnt, 0).sum(1)
    startv = torch.where(chosen & (top == topv[:, None]), startr, -1).amax(1)
    m = feasible
    for vals in (nviol, topv, psumv, cntv, -startv):
        big = float("inf") if vals.dtype == torch.float32 else 2**31 - 1
        m = m & (vals == torch.where(m, vals, big).min())
    winner = torch.where(m.any(), m.to(torch.int32).argmax(), -1)
    return winner, chosen, kidx + 1, nviol, elig.any(1)


def decisions_equal(torch, got, ref):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(got, ref))


def price_row(port, rec, launches):
    """K6 on the storm's last decision's inputs: timed beside the plain
    version and the one-expression yardstick."""
    torch, pk = port.torch, port.pk
    if not rec.storm_price:
        fail("the storm never reached price_nodes (K6)")
    args, _ = rec.storm_price[-1]
    got = pk.price_nodes(*args)
    ref = pk.price_nodes_plain(*args)
    torch.cuda.synchronize()
    if not decisions_equal(torch, got, ref):
        fail("K6 price_nodes disagrees with its plain version")
    ms = time_cuda(torch, lambda: pk.price_nodes(*args), reps=200, warm=5)
    plain_ms, _ = time_host(torch, lambda: pk.price_nodes_plain(*args))
    lib_ms = time_cuda(torch, lambda: price_vectorized(torch, args),
                       reps=50, warm=3)
    N, V, R = args[4].shape
    any_elig = price_vectorized(torch, args)[4]
    # pass 1 walks each row's units until the first fitting one (all V
    # where none fits), each unit R + 1 adds, R + 1 adds of the free
    # space and R + 1 compares; then one pass over V for the costs and
    # five narrowing passes over the rows
    walked = int(torch.where(any_elig, got[2], V).sum())
    ops = walked * 3 * (R + 1) + N * V * 6 + 6 * N
    bytes_ = nbytes(*args, *got)
    b = bound(bytes_, ops)
    return {"name": "price_nodes", "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/price_nodes.cu",
            "replaces": "kubernetes_tpu/scheduler/kernels/preempt.py:359",
            "launches": launches["price_nodes"], "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "match": True,
            "library_call": "the plain expression with torch.cumsum and "
                            "whole-tensor reductions (no one library call "
                            "prices victims)",
            "bytes": bytes_, "ops": ops,
            "shape": f"N={N} V={V} R={R} ({int(args[12].sum())} candidate "
                     "rows, storm's last decision)"}


def gang_table_of_singletons(torch, pb):
    """The entry stream of a batch whose active pods are each a unit of
    their own, in pod order (core._gang_device_table's layout for a batch
    without PodGroups), with the capacity gate's need / greq."""
    P = pb["seq"].shape[0]
    N = pb["unique_masks"].shape[1]
    dev = pb["seq"].device
    idx = pb["active"].nonzero().flatten().to(torch.int32)
    pod_idx = torch.full((P,), -1, dtype=torch.int32, device=dev)
    pod_idx[:idx.numel()] = idx
    need = torch.zeros((P,), dtype=torch.float32, device=dev)
    need[:idx.numel()] = 1.0
    greq = torch.zeros_like(pb["req"])
    greq[:idx.numel()] = pb["req"][idx.long()]
    return {"pod_idx": pod_idx,
            "start": torch.ones((P,), dtype=torch.bool, device=dev),
            "end": torch.ones((P,), dtype=torch.bool, device=dev),
            "gang_id": torch.arange(P, dtype=torch.int32, device=dev),
            "entry_dom_idx": torch.full((P,), -1, dtype=torch.int32,
                                        device=dev),
            "pin_dom": torch.full((P,), -1, dtype=torch.int32, device=dev),
            "dom_tab": torch.full((1, N), -1, dtype=torch.int32,
                                  device=dev),
            "need": need, "greq": greq}


def gang_members_table(torch, gt):
    """[G, M] int32 pod rows of the gangs (units of more than one entry)
    of a gang table, -1 padded."""
    import numpy as np
    pod_idx = gt["pod_idx"].cpu().numpy()
    gid = gt["gang_id"].cpu().numpy()
    units = {}
    for t, (i, g) in enumerate(zip(pod_idx, gid)):
        if i >= 0:
            units.setdefault(int(g), []).append(int(i))
    gangs = [m for m in units.values() if len(m) > 1]
    M = max((len(m) for m in gangs), default=1)
    out = np.full((max(len(gangs), 1), M), -1, np.int32)
    for r, m in enumerate(gangs):
        out[r, :len(m)] = m
    return torch.tensor(out, device=gt["pod_idx"].device)


def gang_row(port, rec, launches, name, path):
    """K9's instance on the largest batch of `path`: held against
    gang_schedule_plain on the card (assign, the score bits of every pod,
    the committed usage bits), K9 alone timed on a fresh carry."""
    torch, gk = port.torch, port.gk
    if (path, name) not in rec.gang_inputs:
        fail(f"the {path} path never launched {name}")
    node_cfg, usage, pb, gt, nom, mates = rec.gang_inputs[(path, name)]
    packed_k, use_k = gk.gang_schedule_packed(node_cfg, usage, pb, gt, nom,
                                              mates)
    with PlainOnCard(port):
        plain_ms, (packed_p, use_p) = time_host(
            torch, lambda: gk.gang_schedule_packed(node_cfg, usage, pb, gt,
                                                   nom, mates))
    if not torch.equal(packed_k, packed_p):
        fail(f"K9 {name} disagrees with its plain version on the {path} "
             f"batch ({int((packed_k != packed_p).sum())} packed entries)")
    if set(use_k) != set(use_p) or not all(
            bits_equal(torch, use_k[k], use_p[k]) for k in use_p):
        fail(f"K9 {name} committed usage disagrees on the {path} batch")
    err = max(max_abs(torch, packed_k[0], packed_p[0]),
              max_abs(torch, packed_k[1].view(torch.float32),
                      packed_p[1].view(torch.float32)),
              *(max_abs(torch, use_k[k], use_p[k]) for k in use_p))

    def scan_only():
        # a fresh carry for each run; only the scan is timed
        carry, _ = port.kb._carry_setup(usage, pb)
        return lambda: gk._gang_scan_cuda(node_cfg, pb, gt, carry, nom,
                                          mates)
    runs = [time_cuda(torch, scan_only(), reps=1, warm=0) for _ in range(3)]
    ms = sum(runs[1:]) / 2   # the first run pays the library load
    N, R = node_cfg["alloc"].shape
    P = pb["seq"].shape[0]
    T = gt["pod_idx"].shape[0]
    entries = int((gt["pod_idx"] >= 0).sum())
    placed = int((packed_k[0] >= 0).sum())
    units = int(gt["start"][gt["pod_idx"] >= 0].sum())
    gated = 0
    if "need" in gt:
        gated = int((gt["start"] & (gt["entry_dom_idx"] >= 0)
                     & (gt["pin_dom"] < 0) & (gt["need"] > 0)
                     & (gt["pod_idx"] >= 0)).sum())
    rejected = int(((packed_k[0] < 0) & pb["active"]).sum())
    bytes_ = nbytes(*node_cfg.values(), *usage.values(), pb["req"],
                    pb["nonzero_req"], pb["mem_pressure_blocked"],
                    pb["mask_idx"], pb["score_idx"], pb["seq"],
                    pb["active"], pb["unique_masks"], pb["unique_scores"],
                    pb["resource_weights"], *gt.values(), packed_k,
                    *use_k.values())
    # per (entry, row), as pod_scan_row counts the step: fits 2R + 2, the
    # domain mask 3, the resource score ~25, the select, the tie penalty
    # and the argmax compare 5; with the overlay the 2R + 2 folds; per
    # placing member the R + 3 usage adds; per gated gang start, at every
    # row, R subtractions, divisions, floors and minima and the slot
    # count, its clamp and the domain sum (4R + 6)
    per_row = 2 * R + 2 + 3 + 25 + 5
    if nom is not None:
        bytes_ += nbytes(*nom.values(), pb["nom_row"])
        per_row += 2 * R + 2
    ops = entries * N * per_row + placed * (R + 3) + gated * N * (4 * R + 6)
    b = bound(bytes_, ops)
    return {"name": name, "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/gang_scan.cu + pod.cuh",
            "replaces": "kubernetes_tpu/scheduler/kernels/gang.py:93",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "match": True,
            "bytes": bytes_, "ops": ops,
            "shape": f"T={T} ({entries} entries, {units} units, {gated} "
                     f"gated gang starts, {placed} placed) P={P} N={N} "
                     f"R={R} ({path} batch)",
            "rejected_pods": rejected}


def gang_singleton_replay(port, rec):
    """K9 on the uniform path's first batch as singletons in pod order
    (class tables dropped) against K7 pod_scan on the same batch: the same
    assign and the same score bits on every active pod (gang.py :30-33);
    a pad's score is NEG in the gang scan, which never scans a pad."""
    torch, kb, gk = port.torch, port.kb, port.gk
    node_cfg, usage, pb, _ = rec.scan_inputs["uniform"]
    cpb = classic_batch(kb, pb)
    gt = gang_table_of_singletons(torch, cpb)
    packed_g, use_g = gk.gang_schedule_packed(node_cfg, usage, cpb, gt)
    packed_c, use_c = kb.schedule_batch_packed(node_cfg, usage, cpb)
    torch.cuda.synchronize()
    active = cpb["active"]
    if not torch.equal(packed_g[0], packed_c[0]):
        n = int((packed_g[0] != packed_c[0]).sum())
        fail(f"K9 on the uniform batch as singletons assigns {n} pods "
             "unlike K7")
    if not torch.equal(packed_g[1][active], packed_c[1][active]):
        fail("K9 on the uniform batch as singletons scores active pods "
             "unlike K7")
    for k in ("used", "nonzero_used", "pod_count"):
        if not bits_equal(torch, use_g[k], use_c[k]):
            fail(f"K9 on the uniform batch as singletons ends with {k} "
                 "unlike K7")
    return {"pods": int(active.sum()),
            "placed": int((packed_g[0] >= 0).sum())}


def gang_mates_replay(port, rec, entries=MATES_REPLAY_ENTRIES):
    """K9 with the nominated overlay and the own-gang exemption (the
    instance the gang-preemption path launches, there on batches of one
    gang) on the gang path's largest batch cut to its first `entries`
    entries (whole units), at the path's full width: the members of the
    gangs among every fourth unit hold reservations, two to a node, so
    those gangs read the overlay less their own reservations and every
    other unit reads them. Held against the plain version on the card
    (packed results and usage bits)."""
    import numpy as np
    torch, gk = port.torch, port.gk
    node_cfg, usage, pb, gt, _, _ = rec.gang_inputs[("gang",
                                                     "gang_scan_cap")]
    end = gt["end"].cpu().numpy()
    cut = int(np.flatnonzero(end[entries - 1:])[0]) + entries
    g = {k: (v if k == "dom_tab" else v[:cut]) for k, v in gt.items()}
    pod_idx = g["pod_idx"].cpu().numpy()
    gid = g["gang_id"].cpu().numpy()
    N, R = node_cfg["alloc"].shape
    n_nodes = int(node_cfg["valid"].sum())
    rng = np.random.default_rng(0)
    nom_row = np.full((pb["seq"].shape[0],), -1, np.int32)
    used = np.zeros((N, R), np.float32)
    count = np.zeros((N,), np.float32)
    req = pb["req"].cpu().numpy()
    units = sorted(set(int(x) for x in gid[pod_idx >= 0]))
    nominated = 0
    for u in units[::4]:
        members = pod_idx[(gid == u) & (pod_idx >= 0)]
        if len(members) < 2:
            continue
        for j, i in enumerate(members):
            if j % 2 == 0:
                r = int(rng.integers(0, n_nodes))
            nom_row[i] = r
            used[r] += req[i]
            count[r] += 1.0
            nominated += 1
    dev = pb["seq"].device
    pbn = dict(pb, nom_row=torch.tensor(nom_row, device=dev))
    nom = {"used": torch.tensor(used, device=dev),
           "count": torch.tensor(count, device=dev)}
    packed_k, use_k = gk.gang_schedule_packed(node_cfg, usage, pbn, g, nom,
                                              exempt_mates=True)
    ms = time_cuda(torch, lambda: gk.gang_schedule_packed(
        node_cfg, usage, pbn, g, nom, exempt_mates=True), reps=2, warm=0)
    with PlainOnCard(port):
        plain_ms, (packed_p, use_p) = time_host(
            torch, lambda: gk.gang_schedule_packed(node_cfg, usage, pbn, g,
                                                   nom, exempt_mates=True))
    if not torch.equal(packed_k, packed_p):
        fail("K9 gang_scan_cap_nom with exempt mates disagrees with its "
             f"plain version on the gang batch's first {cut} entries "
             f"({int((packed_k != packed_p).sum())} packed entries)")
    if not all(bits_equal(torch, use_k[k], use_p[k]) for k in use_p):
        fail("K9 gang_scan_cap_nom with exempt mates: committed usage "
             "disagrees")
    return {"entries": cut, "units": len(units),
            "nominated_members": nominated,
            "placed": int((packed_k[0] >= 0).sum()), "ms": ms,
            "plain_ms": plain_ms, "equal": True}


def domains_vectorized(torch, a):
    """price_domains as one plain PyTorch expression (torch.cumsum and
    whole-tensor reductions, no loop over the units): the yardstick
    beside K11, timed, not held bit for bit."""
    (base, need, dslots, valid, pdb, top, psum, gcnt, startr,
     row_valid) = a
    U = valid.shape[1]
    cums = base[:, None] + torch.cumsum(torch.where(valid, dslots, 0.0), 1)
    fit0 = base >= need
    fitk = (cums >= need) & valid
    kidx = fitk.to(torch.int32).argmax(1)
    feasible = (fitk.any(1) | fit0) & row_valid
    chosen = valid & (torch.arange(U, device=valid.device)[None, :]
                      <= kidx[:, None]) & (~fit0)[:, None] \
        & feasible[:, None]
    nviol = (chosen & pdb).sum(1)
    topv = torch.where(chosen, top, -2**31).amax(1)
    psumv = torch.where(chosen, psum, 0.0).sum(1)
    cntv = torch.where(chosen, gcnt, 0).sum(1)
    startv = torch.where(chosen & (top == topv[:, None]), startr, -1).amax(1)
    m = feasible
    for vals in (nviol, topv, psumv, cntv, -startv):
        big = float("inf") if vals.dtype == torch.float32 else 2**31 - 1
        m = m & (vals == torch.where(m, vals, big).min())
    winner = torch.where(m.any(), m.to(torch.int32).argmax(), -1)
    return winner, chosen, nviol


def domains_row(port, rec, launches):
    """K11 on the gang storm's last decision's inputs: timed beside the
    plain version and the one-expression yardstick."""
    torch, pk = port.torch, port.pk
    if not rec.storm_domains:
        fail("the gang storm never reached price_domains (K11)")
    args, _ = rec.storm_domains[-1]
    got = pk.price_domains(*args)
    ref = pk.price_domains_plain(*args)
    torch.cuda.synchronize()
    if not decisions_equal(torch, got, ref):
        fail("K11 price_domains disagrees with its plain version")
    ms = time_cuda(torch, lambda: pk.price_domains(*args), reps=200, warm=5)
    plain_ms, _ = time_host(torch, lambda: pk.price_domains_plain(*args))
    # the keyless gang's decision (the storm's first): one row of U units
    free_args, _ = rec.storm_domains[0]
    free_ms = time_cuda(torch, lambda: pk.price_domains(*free_args), reps=5,
                        warm=1)
    free_plain_ms, _ = time_host(torch,
                                 lambda: pk.price_domains_plain(*free_args))
    lib_ms = time_cuda(torch, lambda: domains_vectorized(torch, args),
                       reps=50, warm=3)
    D, U = args[2].shape
    bytes_ = nbytes(*args, *got)
    # pass 1 walks each domain's units to its first fitting prefix (all U
    # where none fits): 3 operations a unit; then one cost pass over U
    # (6 a unit) and five narrowing passes over the rows
    cums = torch.cumsum(torch.where(args[3], args[2], 0.0), 1) \
        + args[0][:, None]
    fitk = (cums >= args[1]) & args[3]
    walked = int(torch.where(fitk.any(1), fitk.to(torch.int32).argmax(1)
                             + 1, U).sum())
    ops = walked * 3 + D * U * 6 + 6 * D
    b = bound(bytes_, ops)
    return {"name": "price_domains", "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/price_domains.cu"
                      " + price.cuh",
            "replaces": "kubernetes_tpu/scheduler/kernels/preempt.py:581",
            "launches": launches["price_domains"], "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "match": True,
            "library_call": "the plain expression with torch.cumsum and "
                            "whole-tensor reductions (no one library call "
                            "prices domains)",
            "bytes": bytes_, "ops": ops,
            "shape": f"D={D} U={U} ({int(args[9].sum())} domain rows, gang "
                     "storm's last decision)",
            "keyless_ms": free_ms, "keyless_plain_ms": free_plain_ms,
            "keyless_shape": list(free_args[2].shape)}


def feasible_row(port, rec, launches):
    """K10 on the gang-feasible path's inputs (K8's mask of the gang
    batch, the batch's gangs): timed beside the plain version and the
    PyTorch expression fits.any(1), gather, .all(1)."""
    torch, gk = port.torch, port.gk
    fits, members = rec.feasible_inputs
    got = gk.gang_feasible(fits, members)
    plain_ms, want = time_host(torch, lambda: gk.gang_feasible_plain(
        fits, members))
    if not torch.equal(got, want):
        fail("K10 gang_feasible disagrees with its plain version")
    ms = time_cuda(torch, lambda: gk.gang_feasible(fits, members), reps=50,
                   warm=3)
    lib_ms = time_cuda(torch, lambda: (
        fits.any(1)[members.clamp_min(0).long()] | (members < 0)).all(1),
                       reps=50, warm=3)
    P, N = fits.shape
    G, M = members.shape
    bytes_ = nbytes(fits, members, got)
    b = bound(bytes_, P * N + 2 * G * M)
    return {"name": "gang_feasible", "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/gang_feasible.cu",
            "replaces": "kubernetes_tpu/scheduler/kernels/gang.py:75",
            "launches": launches["gang_feasible"], "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "match": True,
            "library_call": "(fits.any(1)[members] | members < 0).all(1), "
                            "one expression of four calls",
            "bytes": bytes_, "ops": P * N + 2 * G * M,
            "feasible_gangs": int(got.sum()),
            "shape": f"P={P} N={N} G={G} M={M} (gang batch)"}


def affinity_rows(port, route, launches):
    """K13 on the largest required_masks call of the service-anti-affinity
    path (bucket-padded as the wrapper pads it) and K14 on integer inputs
    of the same shapes made from SCORES_SEED, each held bit for bit
    against its plain version on the card and timed beside it and the
    PyTorch expression with torch.matmul (TF32 off)."""
    import numpy as np
    torch, ak = port.torch, port.ak
    dev = torch.device("cuda")
    has_dom, present, sel_dom, sel_present, sel_absent = route.largest
    T, N = has_dom.shape
    U = sel_dom.shape[0]
    Tb, Ub = ak._bucket(T), ak._bucket(U)
    args = (ak._padded(has_dom, (Tb, N), torch.bool, dev),
            ak._padded(present, (Tb, N), torch.bool, dev),
            *(ak._padded(a, (Ub, Tb), torch.float32, dev)
              for a in (sel_dom, sel_present, sel_absent)))
    got = ak.affinity_masks_tensors(*args)
    plain_ms, want = time_host(torch, lambda: ak.affinity_masks_plain(*args))
    if not torch.equal(got, want):
        fail(f"K13 affinity_masks disagrees with its plain version "
             f"({int((got != want).sum())} of {got.numel()} entries)")
    ms = time_cuda(torch, lambda: ak.affinity_masks_tensors(*args), reps=20,
                   warm=2)
    lib_ms = time_cuda(torch, lambda: ak.affinity_masks_plain(*args),
                       reps=20, warm=2)
    bytes_ = nbytes(*args, got)
    ops = 6 * Ub * Tb * N
    b = bound(bytes_, ops)
    rows = [{"name": "affinity_masks", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/affinity_masks.cu",
             "replaces": "kubernetes_tpu/scheduler/kernels/affinity.py:39",
             "launches": launches["affinity_masks"], "max_abs_err": 0.0,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": lib_ms, "match": True,
             "library_call": "(sd @ (1 - hd) + sp @ (1 - pr)) + sa @ pr "
                             "== 0 with torch.matmul, TF32 off",
             "bytes": bytes_, "ops": ops,
             "mask_true_share": float(got[:U].float().mean()),
             "shape": f"U={U} (Ub={Ub}) T={T} (Tb={Tb}) N={N} (the "
                      "largest call of service-anti-affinity)"}]
    rng = np.random.default_rng(SCORES_SEED)
    w = ak._padded(rng.integers(-100, 101, (Ub, Tb)), (Ub, Tb),
                   torch.float32, dev)
    c = ak._padded(rng.integers(0, 51, (Tb, N)), (Tb, N), torch.float32,
                   dev)
    got = ak.affinity_scores_tensors(w, c)
    plain_ms, want = time_host(torch, lambda: ak.affinity_scores_plain(w, c))
    if not bits_equal(torch, got, want):
        fail(f"K14 affinity_scores disagrees with its plain version (max "
             f"abs {max_abs(torch, got, want)})")
    ms = time_cuda(torch, lambda: ak.affinity_scores_tensors(w, c), reps=20,
                   warm=2)
    lib_ms = time_cuda(torch, lambda: w @ c, reps=20, warm=2)
    bytes_ = nbytes(w, c, got)
    ops = 2 * Ub * Tb * N
    b = bound(bytes_, ops)
    rows.append({"name": "affinity_scores", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/affinity_scores.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/affinity.py:47",
                 "launches": launches["affinity_scores"],
                 "max_abs_err": max_abs(torch, got, want), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                 "library_ms": lib_ms, "match": True,
                 "library_call": "weights @ counts (torch.matmul, TF32 off)",
                 "bytes": bytes_, "ops": ops,
                 "shape": f"U={Ub} T={Tb} N={N} (K13's padded shapes; "
                          f"integer weights in [-100, 100], counts in "
                          f"[0, 50], seed {SCORES_SEED})"})
    return rows


def verify_domains(port, log, label):
    """Every K11 decision kept in `log` against price_domains_plain on the
    same inputs; returns the number held."""
    torch, pk = port.torch, port.pk
    bad = sum(not decisions_equal(torch, got, pk.price_domains_plain(*args))
              for args, got in log)
    torch.cuda.synchronize()
    if bad or not log:
        fail(f"{label}: {bad} of {len(log)} K11 decisions differ from "
             "price_domains_plain (or none was priced)")
    return len(log)


def verify_nom_launches(port, rec):
    """Every nominated scan launch kept on the nominated and preemption
    paths, held against the plain versions on the same inputs. Returns
    {path: (launches, launches with a nominee's own row)}."""
    torch = port.torch
    out = {}
    for path, inputs, packed, new_usage in rec.nom_launches:
        node_cfg, usage, pb, nom = inputs
        check_scan(port, node_cfg, usage, pb, f"{path} nominated", nom,
                   packed, new_usage)
        n, selfs = out.get(path, (0, 0))
        out[path] = (n + 1, selfs + int(bool((pb["nom_row"] >= 0).any())))
    torch.cuda.synchronize()
    return out


def run_storm(port, device, n_nodes, n_pods, kernel):
    """bench.py run_storm: the storm cluster straight into a cache, the
    preemptors through BatchScheduler.preempt one by one, each plan's
    victims removed from the cache. `kernel` False is the serial
    reprieve control (KTPU_PREEMPT_KERNEL=0)."""
    cache, pdbs = port.wl.storm_cache(port.api, port.Cache, n_nodes)
    sched = port.BatchScheduler(cache, pdb_lister=lambda: pdbs,
                                device=device)
    sched.preempt_kernel = kernel
    plans = []
    t0 = time.perf_counter()
    for i in range(n_pods):
        plan = sched.preempt(port.wl.storm_preemptor(port.api, i))
        if plan is not None:
            plans.append((plan.node_name,
                          [v.metadata.key() for v in plan.victims],
                          plan.num_pdb_violations))
            for v in plan.victims:
                cache.remove_pod(v)
    elapsed = time.perf_counter() - t0
    return {"plans": plans, "elapsed": elapsed,
            "victims": sum(len(p[1]) for p in plans),
            "pdb_violations": sum(p[2] for p in plans)}


def run_preemption_loop(port, device, n_nodes, n_pods, batch):
    """The storm cluster created through the port's Client (nodes, bound
    victims, the PDB object), n_pods preemptors created pending, and
    Scheduler.drain_pipelined with preemption on until nothing is
    pending (workload.drain_until_idle: the informer events delivered on
    this thread, a FakeClock stepped past backoffs)."""
    clock = port.FakeClock()
    client = port.Client(validate=False)
    t0 = time.perf_counter()
    victims = port.wl.storm_client(port.api, client, n_nodes)
    sched = port.Scheduler(client, batch_size=batch, device=device,
                           clock=clock)
    pump = port.wl.InformerPump(sched.informers)
    for i in range(n_pods):
        client.pods().create(port.wl.storm_preemptor(port.api, i))
    pump.pump()
    setup_s = time.perf_counter() - t0
    algo = sched.algorithm
    plans = []
    preempt = algo.preempt

    def counted(pod):
        plan = preempt(pod)
        if plan is not None:
            plans.append(pod.metadata.key())
        return plan
    algo.preempt = counted
    t0 = time.perf_counter()
    try:
        bound = port.wl.drain_until_idle(sched, pump, clock)
    finally:
        del algo.preempt
        pump.close()
    wall = time.perf_counter() - t0
    sched.stop()
    pods = {p.metadata.key(): p for p in client.pods().list()}
    return {"sched": sched, "bound": bound, "wall": wall,
            "setup_s": setup_s, "plans": plans,
            "victims": victims, "pods": pods,
            "binds": {k: p.spec.node_name or None for k, p in pods.items()},
            "evicted": sorted(v.metadata.key() for v in victims
                              if v.metadata.key() not in pods),
            "nominated": {k: p.status.nominated_node_name
                          for k, p in pods.items()
                          if p.metadata.name.startswith("hi")},
            "attempts": sched.metrics.preemption_attempts.value(),
            "evictions": sched.metrics.preemption_victims.value(),
            "commit_thread": sched._commit_async}


def check_preemption_loop(port, label, r, n_nodes, n_pods):
    """Every preemptor bound, every evicted victim below its preemptor's
    priority, no node over capacity, and preemption_attempts equal to
    the plans made."""
    hi = {k: p for k, p in r["pods"].items()
          if p.metadata.name.startswith("hi")}
    unbound = [k for k, p in hi.items() if not p.spec.node_name]
    if len(hi) != n_pods or unbound:
        fail(f"{label}: {len(unbound)} of {n_pods} preemptors did not bind")
    prio = {v.metadata.key(): v.spec.priority for v in r["victims"]}
    above = [k for k in r["evicted"] if prio[k] >= PREEMPTOR_PRIORITY]
    if above:
        fail(f"{label}: evicted victims at or above the preemptors' "
             f"priority: {above[:5]}")
    if not r["evicted"]:
        fail(f"{label}: no victim was evicted")
    pods = list(r["pods"].values())
    check_capacity(port, label, n_nodes, pods,
                   {p.metadata.key(): p.spec.node_name for p in pods})
    if r["attempts"] != len(r["plans"]):
        fail(f"{label}: preemption_attempts {r['attempts']} != "
             f"{len(r['plans'])} plans made")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed ({e})")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    sys.path.insert(0, HERE)
    try:
        import kubernetes_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the kubernetes_tpu_torch package is not here ({e}); run "
             "from a checkout of the repository")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build
    from kubernetes_tpu_torch.scheduler.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    print(f"build: {len(built)} kernels with nvcc (sm_90a) in "
          f"{time.perf_counter() - t0:.1f} s, in parallel")
    for k, v in built.items():
        info = [ln.strip() for ln in v["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {k}: {os.path.basename(v['path'])}: {' | '.join(info)}")
    port = Port()
    kb = port.kb
    dev = torch.device("cuda")

    #: (label, seconds since the previous lap) of the script's phases
    laps = []
    t_lap = [time.perf_counter()]

    def lap(label):
        # what a phase leaves alive (each path keeps its 5k-50k-pod
        # cluster for the checks) moves out of the collector's reach, so
        # a later path's full collections do not walk every earlier
        # path's objects
        gc.freeze()
        now = time.perf_counter()
        laps.append((label, round(now - t_lap[0], 1)))
        t_lap[0] = now
    lap("build")

    # ---- main paths: counts zeroed just before each, read just after
    rec = Recorder(port)
    per_path = {}
    drains = {}
    with rec:
        for variant, chain in (("uniform", True), ("spread", False)):
            rec.variant = variant
            port.reset_launches()
            sched, pods, res, wall = run_drain(
                port, variant, dev, N_NODES, N_PODS, BATCH, chain)
            per_path[variant] = port.launches()
            lap(variant)
            drains[variant] = (sched, pods, res, wall)
        rec.variant = "scheduler"
        port.reset_launches()
        sp = run_scheduler_drain(port, dev, N_NODES, N_PODS, BATCH)
        per_path["scheduler"] = port.launches()
        lap("scheduler")
        aff = {}
        for path, (variant, n_nodes, n_pods) in SCHED_PATHS.items():
            rec.variant = path
            port.reset_launches()
            aff[path] = run_scheduler_drain(port, dev, n_nodes, n_pods,
                                            BATCH, variant)
            per_path[path] = port.launches()
            lap(path)
        # the required-affinity mask route (K13): every required_masks
        # call held against the host route
        route = MaskRoute(port)
        for path, (variant, n_nodes, n_pods) in SVC_PATHS.items():
            rec.variant = path
            port.reset_launches()
            with route:
                aff[path] = run_scheduler_drain(port, dev, n_nodes, n_pods,
                                                BATCH, variant)
            per_path[path] = port.launches()
            lap(path)
        # the classic per-pod route (K7) over the same clusters
        with env_set("KTPU_CLASS_SCAN", "0"):
            for path, (variant, chain) in CLASSIC_DRAINS.items():
                rec.variant = path
                port.reset_launches()
                drains[path] = run_drain(port, variant, dev, N_NODES, N_PODS,
                                         BATCH, chain)
                per_path[path] = port.launches()
                lap(path)
            for path, (variant, n_nodes, n_pods) in CLASSIC_SCHED.items():
                rec.variant = path
                port.reset_launches()
                aff[path] = run_scheduler_drain(port, dev, n_nodes, n_pods,
                                                BATCH, variant)
                per_path[path] = port.launches()
                lap(path)
        rec.variant = "storm"
        rec.price_log = rec.storm_price
        port.reset_launches()
        storm = run_storm(port, dev, STORM_NODES, STORM_PODS, True)
        per_path["storm"] = port.launches()
        lap("storm")
        rec.price_log = None
        rec.variant = "preemption"
        port.reset_launches()
        loop = run_preemption_loop(port, dev, STORM_NODES, STORM_PODS, BATCH)
        per_path["preemption"] = port.launches()
        lap("preemption")
        # gangs: BASELINE.json config 5, the gang storm, the gang loop
        rec.variant = "gang"
        port.reset_launches()
        gang = run_gang_drain(port, dev, GANG_NODES, GANG_PODS,
                              GANG_SLICE_GANGS, GANG_PLAIN_GANGS, BATCH)
        per_path["gang"] = port.launches()
        lap("gang")
        rec.variant = "gang-storm"
        rec.domain_log = rec.storm_domains
        port.reset_launches()
        gstorm = run_gang_storm(port, dev, STORM_NODES, GANG_STORM_REPEATS,
                                GANG_STORM_KEYLESS)
        per_path["gang-storm"] = port.launches()
        lap("gang-storm")
        storm_tables_s = list(rec.domain_tables_s)
        rec.variant = "gang-preemption"
        rec.domain_log = rec.loop_domains
        port.reset_launches()
        gloop = run_gang_preemption(port, dev, STORM_NODES,
                                    GANG_PREEMPT_GANGS, BATCH)
        per_path["gang-preemption"] = port.launches()
        lap("gang-preemption")
        rec.domain_log = None
        # the speculative cohort route (K12) with the divergence oracle
        spec = {}
        for path, (variant, n_nodes, n_pods, forced) in SPEC_SCHED.items():
            rec.variant = path
            port.reset_launches()
            with env_set("KTPU_SPEC_ORACLE", "1"), spec_gate(port, forced):
                spec[path] = run_scheduler_drain(port, dev, n_nodes, n_pods,
                                                 BATCH, variant,
                                                 speculative=True)
            per_path[path] = port.launches()
            lap(path)
        for path, variant in SPEC_DRAINS.items():
            rec.variant = path
            port.reset_launches()
            with spec_gate(port, True):
                drains[path] = run_drain(port, variant, dev, N_NODES, N_PODS,
                                         BATCH, False, speculative=True)
            per_path[path] = port.launches()
            lap(path)
    # the serial control: no kernel prices it
    port.reset_launches()
    serial = run_storm(port, dev, STORM_NODES, STORM_PODS, False)
    if port.launches()["price_nodes"]:
        fail("the serial storm (KTPU_PREEMPT_KERNEL=0) launched K6")
    lap("serial storm")
    # filter_score, the [P, N] entry point, on the uniform and spread
    # paths' first batches (no scheduler route calls it)
    port.reset_launches()
    for path in ("uniform", "spread"):
        node_cfg, usage, pb, _ = rec.scan_inputs[path]
        fits, _ = port.filter_score(node_cfg, usage, pb)
        if not bool(fits.any()):
            fail(f"filter_score: no pod fits anywhere on the {path} batch")
        del fits
    per_path["filter"] = port.launches()
    lap("filter")
    # gang_feasible (K10), the per-gang reduction of K8's mask, on the gang
    # path's largest batch (no scheduler route calls it)
    if ("gang", "gang_scan_cap") not in rec.gang_inputs:
        fail("the gang path never launched gang_scan_cap")
    node_cfg, usage, pb, gt = rec.gang_inputs[("gang", "gang_scan_cap")][:4]
    port.reset_launches()
    fits, _ = port.filter_score(node_cfg, usage, pb)
    members = gang_members_table(torch, gt)
    feasible = port.gk.gang_feasible(fits, members)
    per_path["gang-feasible"] = port.launches()
    lap("gang-feasible")
    rec.feasible_inputs = (fits, members)
    if not bool(feasible.all()):
        fail(f"gang-feasible: {int((~feasible).sum())} gangs of the "
             "batch fit nowhere")
    # affinity_scores (K14), which no scheduler route calls, on integer
    # inputs of the shapes of the largest K13 call
    if route.largest is None:
        fail("service-anti-affinity: no required_masks call reached K13")
    import numpy as np
    rng = np.random.default_rng(SCORES_SEED)
    T_l, N_l = route.largest[0].shape
    U_l = route.largest[2].shape[0]
    port.reset_launches()
    scores = port.ak.affinity_scores(
        rng.integers(-100, 101, (U_l, T_l)).astype(np.float32),
        rng.integers(0, 51, (T_l, N_l)).astype(np.float32), device=dev)
    per_path["affinity-scores"] = port.launches()
    lap("affinity-scores")
    if scores.shape != (U_l, N_l) or not np.isfinite(scores).all():
        fail(f"affinity_scores: {scores.shape} scores, not finite")
    for path, kernels in PATH_KERNELS.items():
        for k in kernels:
            if per_path[path][k] == 0:
                fail(f"kernel {k} was never launched on the {path} path")
    for k in ("drf_dominant", "drf_order"):
        if per_path["scheduler"][k] < 4:
            fail(f"{k} launched {per_path['scheduler'][k]} times on the "
                 "scheduler path; a drain of 50,000 pods in batches of "
                 "16,384 orders at least 4 pops on the card")
    launches = {k: sum(c[k] for c in per_path.values())
                for k in per_path["uniform"]}
    torch.cuda.synchronize()
    for variant, (sched, pods, res, wall) in drains.items():
        check_capacity(port, variant, N_NODES, pods, res.binds)
        bs = [s * 1e3 for s in res.batch_seconds]
        busy = sum(a.elapsed_time(b) for v, a, b in rec.events
                   if v == variant)
        print(f"main path: {variant} drain of {N_PODS} pods onto {N_NODES}"
              f" nodes, batches of {BATCH} ({res.batches} batches, "
              f"{res.chained} chained): all bound, capacity held; "
              f"{wall} s = {N_PODS / wall} pods/s; batch latency p50 "
              f"{pct(bs, 0.5)} ms p99 {pct(bs, 0.99)} ms; launches "
              f"{per_path[variant]}; host phases (s): launch "
              f"{res.launch_s} finish {res.finish_s} commit {res.commit_s}"
              f", inside them {sched.phase_stats}; device busy in the "
              f"kernel calls {busy} ms of {wall * 1e3} ms wall, idle share "
              f"{1 - busy / (wall * 1e3)} {tag}")
    for variant in drains:
        if variant not in rec.scan_inputs:
            fail(f"the {variant} drain never reached the scan")
    for path, (variant, _) in CLASSIC_DRAINS.items():
        got, want = drains[path][2].binds, drains[variant][2].binds
        n = sum(got.get(k) != v for k, v in want.items())
        if n or len(got) != len(want):
            fail(f"{path}: {n} of {len(want)} binds differ from the "
                 f"{variant} path's (the class route's)")
        print(f"{path}: the classic route binds every pod as the {variant} "
              "path's class route did")
    for path in (*CLASSIC_DRAINS, *CLASSIC_SCHED):
        ran = [k for k, v in per_path[path].items()
               if v and k.startswith("class_")]
        if ran:
            fail(f"{path}: the classic route launched class-route kernels "
                 f"{ran}")
    # the scheduler loop: every pod bound in the store, capacity held
    if sp["bound"] != N_PODS:
        fail(f"scheduler: drain_pipelined bound {sp['bound']} of {N_PODS}")
    check_capacity(port, "scheduler", N_NODES, sp["pods"], sp["binds"])
    if not sp["commit_thread"]:
        fail("scheduler: the commit thread was off on the card")
    lat = [t * 1e3 for t in sp["latency"]]
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events
               if v == "scheduler")
    wall = sp["wall"]
    print(f"main path: scheduler drain_pipelined of {N_PODS} pods of "
          f"{N_TENANTS} tenants onto {N_NODES} nodes, batches of {BATCH}, "
          f"commit thread on: all bound in the store, capacity held; "
          f"{wall} s = {N_PODS / wall} pods/s; batch latency (launch to "
          f"committed) p50 {pct(lat, 0.5)} ms p99 {pct(lat, 0.99)} ms over "
          f"{len(lat)} batches; launches {per_path['scheduler']}; host "
          f"phases (s): drf order {sp['phases']['drf_order']} launch "
          f"{sp['phases']['launch']} finish {sp['phases']['finish']} "
          f"commit (commit thread) {sp['phases']['commit']}, inside them "
          f"{sp['phase_stats']}; cluster set-up {sp['setup_s']} s; device "
          f"busy in the kernel calls {busy} ms of {wall * 1e3} ms wall, "
          f"idle share {1 - busy / (wall * 1e3)} {tag}")
    drf_rep = sp["sched"].drf.report()
    print("scheduler: DRF dominant shares after the drain "
          f"{ {t: v['dominant_share'] for t, v in drf_rep['tenants'].items()} }")
    for path, r in aff.items():
        check_affinity_drain(port, path, r)
        lat = [t * 1e3 for t in r["latency"]]
        busy = sum(a.elapsed_time(b) for v, a, b in rec.events
                   if v == path)
        wall = r["wall"]
        variant, n_nodes, n_pods = {**SCHED_PATHS, **CLASSIC_SCHED,
                                    **SVC_PATHS}[path]
        print(f"main path: {path} drain_pipelined of {n_pods} pods "
              f"(variant {variant}, {len(r['seeds'])} seeded pods, "
              f"{len(r['sched'].queue.nominated.by_node())} ghost-nominated "
              f"nodes) onto {n_nodes} nodes, batches of {BATCH}, commit "
              f"thread {'on' if r['commit_thread'] else 'off'}: all bound "
              f"in the store, capacity held; {wall} s = {n_pods / wall} "
              f"pods/s; batch latency (launch to committed) p50 "
              f"{pct(lat, 0.5)} ms p99 {pct(lat, 0.99)} ms over {len(lat)} "
              f"batches; launches {per_path[path]}; host phases (s): "
              f"launch {r['phases']['launch']} finish "
              f"{r['phases']['finish']} commit {r['phases']['commit']}, "
              f"inside them {r['phase_stats']}; cluster set-up "
              f"{r['setup_s']} s; device busy in the kernel calls {busy} "
              f"ms of {wall * 1e3} ms wall, idle share "
              f"{1 - busy / (wall * 1e3)} {tag}")

    # ---- the required-affinity mask route: K13 on every constrained
    # batch, its rows equal to the host route's
    thr = port.topology.DEVICE_EVAL_THRESHOLD
    calls = route.calls
    bad = [c for c in calls if not c["equal"]]
    short = [c for c in calls
             if c["launches"] != 1 or c["U"] * c["T"] * c["cap"] < thr]
    if not calls or bad or short:
        fail(f"service-anti-affinity: {len(calls)} required_masks calls, "
             f"{len(bad)} unlike the host route, {len(short)} that did not "
             f"launch K13 once at U*T*cap >= {thr}: "
             f"{[(c['U'], c['T'], c['cap']) for c in bad + short][:5]}")
    big = max(calls, key=lambda c: c["U"] * c["T"])
    k13 = [a.elapsed_time(b) for v, a, b in rec.mask_events
           if v in SVC_PATHS]

    def mean(key):
        return sum(key(c) for c in calls) / len(calls)
    print(f"service-anti-affinity: {len(calls)} required_masks calls, "
          f"every one through K13 at U*T*capacity >= {thr} (smallest "
          f"{min(c['U'] * c['T'] * c['cap'] for c in calls)}), rows equal "
          f"to the host route's bit for bit; largest U={big['U']} "
          f"T={big['T']} capacity={big['cap']}; (U, T, K13 ms) per call "
          f"{[(c['U'], c['T'], ms) for c, ms in zip(calls, k13)]}; "
          f"seconds a call (inside launch): the whole route "
          f"{mean(lambda c: c['route_s'])}, of which the host's stack and "
          f"selectors {mean(lambda c: c['route_s'] - c['call_s'])} (per "
          f"call {[c['route_s'] - c['call_s'] for c in calls]}) and "
          f"affinity_masks (padding, upload, K13, download) "
          f"{mean(lambda c: c['call_s'])}; K13 busy "
          f"{sum(k13) / max(len(k13), 1)} ms a call over {len(k13)} "
          f"launches; the host route's check {mean(lambda c: c['check_s'])}"
          f" s a call (inside launch, in the wall) {tag}")

    # ---- the speculative route: every pod bound, no divergence
    for path, (variant, n_nodes, n_pods, forced) in SPEC_SCHED.items():
        r = spec[path]
        if variant == "tenants":
            if r["bound"] != n_pods:
                fail(f"{path}: drain_pipelined bound {r['bound']} of "
                     f"{n_pods}")
            check_capacity(port, path, n_nodes, r["pods"], r["binds"])
        else:
            check_affinity_drain(port, path, r)
        m = r["sched"].metrics
        algo = r["sched"].algorithm
        div = m.speculative_divergences.value()
        cohorts = m.speculative_cohorts.value()
        if div or list(algo.spec_divergence_log):
            fail(f"{path}: {div} speculative divergences under the oracle: "
                 f"{list(algo.spec_divergence_log)[:5]}")
        if not cohorts or len(algo.spec_batch_log) == 0:
            fail(f"{path}: no batch took the speculative route")
        lat = [t * 1e3 for t in r["latency"]]
        busy = sum(a.elapsed_time(b) for v, a, b in rec.events if v == path)
        wall = r["wall"]
        print(f"main path: {path} drain_pipelined of {n_pods} pods "
              f"(bench.py {variant}) onto {n_nodes} nodes, batches of "
              f"{BATCH}, Scheduler(speculative=True), contention gate "
              f"{'forced open' if forced else 'at its default'}, the "
              f"divergence oracle ON (KTPU_SPEC_ORACLE=1: every batch "
              f"replayed through K1 + K2 in schedule_finish, counted in the "
              f"wall and the device time): all bound in the store, capacity "
              f"held, scheduler_speculative_divergences_total {div}; "
              f"{wall} s = {n_pods / wall} pods/s; cohorts {cohorts}, "
              f"collided {m.speculative_collisions.value()}, repaired pods "
              f"{m.speculative_repaired.value()}, per batch (width, "
              f"cohorts, collided, repaired) {list(algo.spec_batch_log)}; "
              f"batch latency (launch to committed) p50 {pct(lat, 0.5)} ms "
              f"p99 {pct(lat, 0.99)} ms over {len(lat)} batches; launches "
              f"{per_path[path]}; host phases (s): launch "
              f"{r['phases']['launch']} finish {r['phases']['finish']} "
              f"commit {r['phases']['commit']}, inside them "
              f"{r['phase_stats']}; cluster set-up {r['setup_s']} s; device "
              f"busy in the kernel calls {busy} ms of {wall * 1e3} ms wall, "
              f"idle share {1 - busy / (wall * 1e3)} {tag}")
    for path, cls_path in SPEC_BINDS_AS.items():
        got, want = spec[path]["binds"], aff[cls_path]["binds"]
        if got != want:
            n = sum(got.get(k) != v for k, v in want.items())
            fail(f"{path}: {n} binds differ from the {cls_path} path's "
                 "(the serial scan's)")
        print(f"{path}: the speculative route binds every pod as the "
              f"{cls_path} path's serial scan did")
    for path, variant in SPEC_DRAINS.items():
        sched, _, res, _ = drains[path]
        if list(sched.spec_divergence_log) or not sched.spec_batch_log:
            fail(f"{path}: divergences {list(sched.spec_divergence_log)[:5]}"
                 f", speculative batches {list(sched.spec_batch_log)}")
        n = sum(res.binds.get(k) != v
                for k, v in drains[variant][2].binds.items())
        if n or len(res.binds) != len(drains[variant][2].binds):
            fail(f"{path}: {n} binds differ from the {variant} path's")
        print(f"{path}: the speculative route (oracle on, no divergence; "
              f"per batch (width, cohorts, collided, repaired) "
              f"{list(sched.spec_batch_log)}) binds every pod as the "
              f"{variant} path's serial scan did")
    # ---- the storm: every K6 decision against the plain version
    bad = 0
    for args, got in rec.storm_price:
        if not decisions_equal(torch, got, port.pk.price_nodes_plain(*args)):
            bad += 1
    torch.cuda.synchronize()
    if bad or len(rec.storm_price) != STORM_PODS:
        fail(f"storm: {bad} of {len(rec.storm_price)} K6 decisions differ "
             f"from price_nodes_plain (or fewer than {STORM_PODS} priced)")
    if len(storm["plans"]) != STORM_PODS:
        fail(f"storm: {len(storm['plans'])} plans for {STORM_PODS} "
             "preemptors")
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events if v == "storm")
    shape = tuple(rec.storm_price[-1][0][4].shape)
    print(f"main path: storm of {STORM_PODS} preemptors through "
          f"BatchScheduler.preempt on {STORM_NODES} nodes "
          f"({3 * STORM_NODES} bound victims, PDB over band b0): kernel "
          f"route {len(storm['plans'])} plans, {storm['victims']} victims, "
          f"{storm['pdb_violations']} PDB violations in {storm['elapsed']} "
          f"s = {len(storm['plans']) / storm['elapsed']} plans/s, K6 over "
          f"[N, V, R] = {list(shape)}, all {len(rec.storm_price)} decisions "
          f"equal to price_nodes_plain on the card, device busy in K6 "
          f"{busy} ms; serial control (KTPU_PREEMPT_KERNEL=0) "
          f"{len(serial['plans'])} plans, {serial['victims']} victims, "
          f"{serial['pdb_violations']} PDB violations in "
          f"{serial['elapsed']} s = "
          f"{len(serial['plans']) / serial['elapsed']} plans/s; "
          f"launches {per_path['storm']} {tag}")
    # ---- the preemption loop
    check_preemption_loop(port, "preemption", loop, STORM_NODES, STORM_PODS)
    if loop["bound"] != STORM_PODS:
        fail(f"preemption: drain_until_idle bound {loop['bound']} of "
             f"{STORM_PODS}")
    nom_checked = verify_nom_launches(port, rec)
    for path in rec.nom_paths:
        if not nom_checked.get(path, (0, 0))[0]:
            fail(f"{path}: no nominated scan launch to hold")
    if not nom_checked["preemption"][1]:
        fail("preemption: no nominated launch carried a nominee's own row")
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events
               if v == "preemption")
    wall = loop["wall"]
    print(f"main path: preemption drain_pipelined of {STORM_PODS} "
          f"preemptors on the storm cluster ({STORM_NODES} nodes, created "
          f"through the Client with the PDB), commit thread "
          f"{'on' if loop['commit_thread'] else 'off'}: all bound in the "
          f"store, capacity held, {len(loop['evicted'])} victims evicted, "
          f"all below priority {PREEMPTOR_PRIORITY}, preemption_attempts "
          f"{loop['attempts']} = plans made; {wall} s; cluster set-up "
          f"{loop['setup_s']} s; launches {per_path['preemption']}; "
          f"nominated launches held against plain (path: launches, with a "
          f"nominee's own row) {nom_checked}; phase stats "
          f"{loop['sched'].algorithm.phase_stats}; device busy in the "
          f"kernel calls {busy} ms of {wall * 1e3} ms wall, idle share "
          f"{1 - busy / (wall * 1e3)} {tag}")

    # ---- the gang drain (BASELINE.json config 5)
    if gang["bound"] != GANG_PODS:
        fail(f"gang: drain bound {gang['bound']} of {GANG_PODS}")
    check_capacity(port, "gang", GANG_NODES, gang["pods"], gang["binds"])
    check_gangs(port, "gang", GANG_NODES, gang["pods"], gang["binds"],
                gang["groups"])
    lat = [t * 1e3 for t in gang["latency"]]
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events if v == "gang")
    wall = gang["wall"]
    print(f"main path: gang drain_pipelined of {GANG_PODS} pods "
          f"({GANG_SLICE_GANGS} PodGroups of 8 on one tpu/slice, "
          f"{GANG_PLAIN_GANGS} of 4, the rest singletons) onto {GANG_NODES} "
          f"nodes in {GANG_NODES // 8} slices, batches of {BATCH}, commit "
          f"thread {'on' if gang['commit_thread'] else 'off'}: all bound in "
          f"the store, every PodGroup whole, every slice gang in one slice, "
          f"capacity held; {wall} s = {GANG_PODS / wall} pods/s; batch "
          f"latency (launch to committed) p50 {pct(lat, 0.5)} ms p99 "
          f"{pct(lat, 0.99)} ms over {len(lat)} batches; gangs admitted/"
          f"rejected {gang['gangs']}; launches {per_path['gang']}; host "
          f"phases (s): launch {gang['phases']['launch']} finish "
          f"{gang['phases']['finish']} commit {gang['phases']['commit']}, "
          f"inside them {gang['phase_stats']}; cluster set-up "
          f"{gang['setup_s']} s; device busy in the kernel calls {busy} ms "
          f"of {wall * 1e3} ms wall, idle share {1 - busy / (wall * 1e3)} "
          f"{tag}")
    print(f"gang-feasible: K8 + K10 on the gang path's largest batch: "
          f"{int(feasible.sum())} of {members.shape[0]} gangs feasible; "
          f"launches {per_path['gang-feasible']}")
    # ---- the gang storm: every K11 decision against the plain version
    held = verify_domains(port, rec.storm_domains, "gang-storm")
    plans = [p for p in gstorm["plans"] if p is not None]
    free = [p for p in gstorm["keyless_plans"] if p is not None]
    if len(plans) != GANG_STORM_REPEATS or len(free) != GANG_STORM_KEYLESS \
            or held != GANG_STORM_REPEATS + GANG_STORM_KEYLESS:
        fail(f"gang-storm: {len(plans)} + {len(free)} plans, {held} "
             f"decisions for {GANG_STORM_REPEATS} + {GANG_STORM_KEYLESS} "
             "calls")
    if any(p != plans[0] for p in plans) or any(p != free[0] for p in free):
        fail("gang-storm: the repeated decision changed between repeats")
    free_shape = tuple(rec.storm_domains[0][0][2].shape)
    if free_shape[0] != 1 or free_shape[1] <= 1024 or free[0][0] != "":
        fail(f"gang-storm: the keyless gang priced [D, U] = "
             f"{list(free_shape)} in domain {free[0][0]!r}, not the whole "
             "cluster in one row")
    shape = tuple(rec.storm_domains[-1][0][2].shape)
    free_tables_s = storm_tables_s[:GANG_STORM_KEYLESS]
    keyed_tables_s = storm_tables_s[GANG_STORM_KEYLESS:]
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events
               if v == "gang-storm")
    print(f"main path: gang-storm of {GANG_STORM_REPEATS} "
          f"BatchScheduler.preempt_gang calls (8 members of 2 CPU / 3Gi at "
          f"priority {PREEMPTOR_PRIORITY}, minMember 8, tpu/slice) on "
          f"{STORM_NODES} nodes ({3 * STORM_NODES} bound victims): "
          f"{len(plans)} plans, each choosing slice {plans[0][0]} and "
          f"evicting {len(plans[0][1])} victims with {plans[0][3]} PDB "
          f"violations, "
          f"in {gstorm['elapsed']} s = {len(plans) / gstorm['elapsed']} "
          f"plans/s; K11 over [D, U] = {list(shape)}, all {held} decisions "
          f"equal to price_domains_plain on the card, device busy in K11 "
          f"{busy} ms; build_domain_tables (host) "
          f"{sum(keyed_tables_s) / max(len(keyed_tables_s), 1)} s a call; "
          f"before them {len(free)} calls for a gang of 8 with no topology "
          f"key: the whole cluster one row, K11 over [D, U] = "
          f"{list(free_shape)}, each evicting {len(free[0][1])} victims "
          f"across {len({n for _, n in free[0][2]})} nodes, "
          f"{gstorm['keyless_s'] / len(free)} s a plan, of which "
          f"build_domain_tables {sum(free_tables_s) / len(free_tables_s)} s;"
          f" "
          f"launches {per_path['gang-storm']} {tag}")
    # ---- the gang-preemption loop
    check_gang_preemption(port, "gang-preemption", gloop, STORM_NODES,
                          GANG_PREEMPT_GANGS)
    held = verify_domains(port, rec.loop_domains, "gang-preemption")
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events
               if v == "gang-preemption")
    wall = gloop["wall"]
    print(f"main path: gang-preemption of {GANG_PREEMPT_GANGS} gangs of 8 "
          f"arriving one after another on the storm cluster ({STORM_NODES}"
          f" nodes through the Client with the PDB): every gang bound whole "
          f"in one slice, capacity held, {len(gloop['evicted'])} victims "
          f"evicted, all below priority {PREEMPTOR_PRIORITY}, no victim "
          f"PodGroup split, preemption_attempts {gloop['attempts']} = plans "
          f"made, {held} K11 decisions equal to price_domains_plain; {wall} "
          f"s; cluster set-up {gloop['setup_s']} s; launches "
          f"{per_path['gang-preemption']}; phase stats "
          f"{gloop['sched'].algorithm.phase_stats}; device busy in the "
          f"kernel calls {busy} ms of {wall * 1e3} ms wall, idle share "
          f"{1 - busy / (wall * 1e3)} {tag}")

    lap("checks of the main paths")
    # ---- the same drains with the plain versions on the card; the first
    # scan of each is kept, and the kernel phase holds K2 against it
    for variant, chain in (("uniform", True), ("spread", False)):
        port.reset_launches()
        with PlainOnCard(port), FirstScan(port, rec, variant):
            _, _, pres, pwall = run_drain(port, variant, dev, N_NODES,
                                          PLAIN_PODS, BATCH, chain)
        if any(port.launches().values()):
            fail(f"the plain {variant} drain launched kernels")
        kres = drains[variant][2]
        n = sum(pres.binds[k] != kres.binds.get(k) for k in pres.binds)
        if len(pres.binds) != PLAIN_PODS or n:
            fail(f"{variant}: {n} binds differ between the kernels and "
                 "the plain versions on the card")
        print(f"plain versions on the card: {variant} drain of the first "
              f"{PLAIN_PODS} pods binds them as the kernels' drain did "
              f"({pwall} s) {tag}")
    for path, (variant, n_nodes, n_pods) in SCHED_PATHS.items():
        port.reset_launches()
        with PlainOnCard(port), FirstScan(port, rec, path):
            pr = run_scheduler_drain(port, dev, n_nodes, n_pods, BATCH,
                                     variant)
        if any(port.launches().values()):
            fail(f"the plain {path} drain launched kernels")
        if pr["binds"] != aff[path]["binds"]:
            n = sum(pr["binds"][k] != aff[path]["binds"].get(k)
                    for k in pr["binds"])
            fail(f"{path}: {n} binds differ between the kernels and the "
                 "plain versions on the card")
        print(f"plain versions on the card: {path} drain binds equal the "
              f"kernels' ({pr['wall']} s) {tag}")

    # the gang drain with the plain versions: its largest (first) batch,
    # held in gang_row, to keep the script inside its time

    lap("plain drains")
    # ---- kernel phase (on the main path's own inputs)
    rows = kernel_phase(port, rec, route, launches)
    for r in rows:
        r["launches_per_path"] = {v: per_path[v][r["name"]]
                                  for v in per_path}
        print(f"  {r['name']} at {r['shape']}: bit-identical to plain; "
              f"{r['ms']} ms per launch (plain {r['plain_ms']} ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']} ms by "
              f"{r['bound_by']}); {r['launches']} launches on the main "
              f"path {tag}")

    lap("kernel phase")
    # ---- small drain: card against CPU
    for variant in ("uniform", "spread"):
        _, _, gres, _ = run_drain(port, variant, dev, SMALL_NODES,
                                  SMALL_PODS, SMALL_BATCH, True)
        _, _, cres, _ = run_drain(port, variant, "cpu", SMALL_NODES,
                                  SMALL_PODS, SMALL_BATCH, True)
        import numpy as np
        same_scores = all(
            np.float32(gres.scores[k]).view(np.int32)
            == np.float32(cres.scores[k]).view(np.int32)
            for k in cres.scores)
        if gres.binds != cres.binds or not same_scores:
            fail(f"small {variant} drain: the card disagrees with the CPU")
        print(f"small {variant} drain ({SMALL_PODS} pods, {SMALL_NODES} "
              "nodes): card equals CPU, binds and score bits")

    # ---- small scheduler loop, nine tenants: card against CPU. The
    # multi-tenant order depends on commit-thread timing (the commit
    # thread charges DRF usage while the drain thread orders the next
    # pop), so both run with the commit stage inline.
    with env_set("KTPU_COMMIT_THREAD", "0"):
        small = [run_scheduler_drain(port, d, SMALL_NODES, SMALL_PODS,
                                     SMALL_BATCH) for d in (dev, "cpu")]
    g, c = small
    if g["bound"] != SMALL_PODS or g["binds"] != c["binds"]:
        fail("small scheduler drain: the card's binds differ from the "
             "CPU's")
    import numpy as np
    g_sh, c_sh = (r["sched"].drf.dominant_shares() for r in small)
    if g_sh.view(np.int32).tolist() != c_sh.view(np.int32).tolist() or \
            g["sched"].drf.report() != c["sched"].drf.report():
        fail("small scheduler drain: the DRF shares differ between the "
             "card and the CPU")
    print(f"small scheduler drain ({SMALL_PODS} pods of {N_TENANTS} "
          f"tenants, {SMALL_NODES} nodes, batches of {SMALL_BATCH}, "
          "KTPU_COMMIT_THREAD=0): card equals CPU, binds and DRF share "
          "bits")

    # ---- small preemption loop: card against CPU, commit stage inline
    with env_set("KTPU_COMMIT_THREAD", "0"):
        small = [run_preemption_loop(port, d, SMALL_STORM_NODES,
                                     SMALL_STORM_PODS, SMALL_BATCH)
                 for d in (dev, "cpu")]
    for r, d in zip(small, ("card", "CPU")):
        check_preemption_loop(port, f"small preemption ({d})", r,
                              SMALL_STORM_NODES, SMALL_STORM_PODS)
    g, c = small
    for key in ("binds", "evicted", "nominated", "attempts", "evictions"):
        if g[key] != c[key]:
            fail(f"small preemption loop: the card's {key} differ from the "
                 "CPU's")
    print(f"small preemption loop ({SMALL_STORM_PODS} preemptors, "
          f"{SMALL_STORM_NODES} nodes, KTPU_COMMIT_THREAD=0): card equals "
          f"CPU, binds, {len(g['evicted'])} evicted victims and "
          "nominations")

    # ---- small classic scheduler loop (K7), nine tenants: card against
    # CPU, commit stage inline
    port.reset_launches()
    with env_set("KTPU_COMMIT_THREAD", "0"), env_set("KTPU_CLASS_SCAN", "0"):
        small = [run_scheduler_drain(port, d, SMALL_NODES, SMALL_PODS,
                                     SMALL_BATCH) for d in (dev, "cpu")]
    g, c = small
    if not port.launches()["pod_scan"]:
        fail("small classic scheduler drain: K7 never launched on the card")
    if g["bound"] != SMALL_PODS or g["binds"] != c["binds"]:
        fail("small classic scheduler drain: the card's binds differ from "
             "the CPU's")
    print(f"small classic scheduler drain ({SMALL_PODS} pods of {N_TENANTS}"
          f" tenants, {SMALL_NODES} nodes, batches of {SMALL_BATCH}, "
          "KTPU_CLASS_SCAN=0, KTPU_COMMIT_THREAD=0): card equals CPU, binds")

    # ---- small speculative scheduler loop (K12), nine tenants: card
    # against CPU, commit stage inline
    port.reset_launches()
    with env_set("KTPU_COMMIT_THREAD", "0"):
        small = [run_scheduler_drain(port, d, SMALL_NODES, SMALL_PODS,
                                     SMALL_BATCH, speculative=True)
                 for d in (dev, "cpu")]
    g, c = small
    if not port.launches()["spec_scan"]:
        fail("small speculative scheduler drain: K12 never launched on the "
             "card")
    counters = [(r["sched"].metrics.speculative_cohorts.value(),
                 r["sched"].metrics.speculative_collisions.value(),
                 r["sched"].metrics.speculative_repaired.value())
                for r in small]
    if g["bound"] != SMALL_PODS or g["binds"] != c["binds"] or \
            counters[0] != counters[1]:
        fail("small speculative scheduler drain: the card's binds or "
             f"speculative counters differ from the CPU's ({counters})")
    print(f"small speculative scheduler drain ({SMALL_PODS} pods of "
          f"{N_TENANTS} tenants, {SMALL_NODES} nodes, batches of "
          f"{SMALL_BATCH}, Scheduler(speculative=True), "
          "KTPU_COMMIT_THREAD=0): card equals CPU, binds and (cohorts, "
          f"collided, repaired) {counters[0]}")

    # ---- small gang drain and gang-preemption loop: card against CPU,
    # commit stage inline
    with env_set("KTPU_COMMIT_THREAD", "0"):
        small = [run_gang_drain(port, d, *SMALL_GANG, SMALL_BATCH)
                 for d in (dev, "cpu")]
    g, c = small
    if g["bound"] != SMALL_GANG[1] or g["binds"] != c["binds"]:
        fail("small gang drain: the card's binds differ from the CPU's")
    check_gangs(port, "small gang drain", SMALL_GANG[0], g["pods"],
                g["binds"], g["groups"])
    with env_set("KTPU_COMMIT_THREAD", "0"):
        small = [run_gang_preemption(port, d, *SMALL_GANG_PREEMPT,
                                     SMALL_BATCH) for d in (dev, "cpu")]
    for r, d in zip(small, ("card", "CPU")):
        check_gang_preemption(port, f"small gang-preemption ({d})", r,
                              *SMALL_GANG_PREEMPT)
    g, c = small
    for key in ("binds", "evicted", "nominated", "attempts", "evictions"):
        if g[key] != c[key]:
            fail(f"small gang-preemption loop: the card's {key} differ "
                 "from the CPU's")
    print(f"small gang drain ({SMALL_GANG[1]} pods, {SMALL_GANG[0]} nodes) "
          f"and gang-preemption loop ({SMALL_GANG_PREEMPT[1]} gangs, "
          f"{SMALL_GANG_PREEMPT[0]} nodes), KTPU_COMMIT_THREAD=0: card "
          "equals CPU, binds (and evicted victims and nominations)")

    lap("small drains")
    print(f"script phases (s): {laps}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
