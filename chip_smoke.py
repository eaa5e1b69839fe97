"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
   the run fails unless the SASS of K7's bf16 kernel (cuobjdump) holds
   HGMMA (wgmma) and UTMALDG (TMA load) instructions, whose counts it
   prints;
2. every kernel against its plain PyTorch version on the card over a
   sweep of shapes (rtol/atol 1e-5; K1, K2, K5 and K6 bitwise, K3 and K4
   over a hub bitwise; K5 over its plan's edge shapes: one row, a chunk
   less one, exactly, plus one, more than 4 turns of its grid-stride loop,
   D 1/3/4/100/128/130/257, sentinel ids, all ids equal, src 4 bytes
   off 16; K7
   fp32 rtol = atol 2e-5, bf16 1e-2 and each row's rms difference within
   2e-2 of the row's rms; K1, K2 and K6 also at ps = 40 and at 300,000
   partitions, more than one grid of K1 holds; K8 rtol = atol 1e-4
   over hd
   8/16/64/192, H 1/2/4,
   B 1/3/8, S 1/7/256/4096 from a random state), and two launches bitwise
   equal; for K8 also a row alone == the row in its batch at any ``bt``,
   and one launch over S == two with the state carried, bitwise, and its
   plan's shared memory a block equal to the kernel's own layout for
   every hd 1..256, bt 1..8 and cluster size 2/4/8;
3. serving at full width: GCN serving of the products stand-in at its
   real size (2.45 M nodes, D = 100, 64 classes, hidden 16, 2 layers)
   over 8 virtual shards, through ``GNNServeEngine``/``run_trace``, with
   the kernels' launch counts read around it; every request of the trace
   answered; served logits bitwise equal to the offline forward (full and
   cached passes), and a sample held against the plain-version path at
   rtol 2e-4; the ``pb=4`` aggregation (K2) bitwise the ``pb=None`` one
   and held against the plain-version aggregation at rtol/atol 1e-5;
4. the serving launcher at a small scale;
5. K1–K3 timings at the serving shapes (CUDA events), beside the plain
   versions, one PyTorch library call and the memory-rate bound; K1
   bitwise its plain version on every ring group of those shapes, K2
   (``pb=4``) bitwise its plain version and K1, K3 bitwise; K2 timed at
   ``pb`` 1, 2, 4 and 8; K1 timed group by group beside each
   group's partitions, masked-in slots and distinct rows, and its bytes
   split into rows, index and output; each group's longest segment
   and K3's longest serial walk after its hub chunks, and K3 timed with
   the hubs cut at other chunk lengths;
6. full-graph training at full width: GCN (hidden 16, 2 layers) on the
   same graph with ``graph_features`` data, ``ps=16, dist=2``, 8 virtual
   shards, 10 AdamW steps on the kernels with the launch counts read
   around them; step 0's gradients held against the plain-version path
   (rtol 1e-4), run twice bitwise equal, and a fused step against the
   unfused one (rtol 2e-4); step time by CUDA events, a torch.profiler
   breakdown of one step, and K4 held bitwise its plain version on every
   group of the backward's shapes (D = 16) and timed there, also with the
   hubs cut at chunk lengths 64 to 1024;
7. GIN, SAGE and GAT: one training step each on a reduced products
   stand-in (``REDUCED_SCALE``: 122,880 nodes, the models' own widths),
   gradients held against the plain-version path (rtol 1e-4) and, for
   GIN and SAGE, the fused step against the unfused one (rtol 2e-4), and
   one step of GIN and SAGE with their hidden layers on the top-k ring
   (k a quarter of the width), held against the plain-version path;
8. sampled GraphSAGE at full size (hidden 32 × 2, fanout 10, batch 1024,
   a hot cache of N // 8 rows over the pinned host table): 10 steps with
   the launch counts read around them; ``gather_rows`` bitwise equal to
   ``x[ids]`` at capacities 0, N // 8 and N; K5 timed at the step's
   shapes as every kernel is (``ms`` back to back, ``ms_median`` of 25
   calls each timed alone, quartiles), and the same calls enqueued while a
   spin kernel holds the stream (``device_ms``, ``device_ms_median``), with
   its plan and ``bytes_per_s``;
9. the training launcher at a small scale, both branches;
10. the top-k compressed ring at full size: the reference's fig9e
   configuration (GCN 3 × 96, 4 classes, ``ps=8, dist=2``, layer 0
   dense) on the products stand-in with ``graph_features`` data at
   D = 96; k = 96 held bitwise equal to the dense ring; 10 AdamW steps at
   k = 24 (lr 2e-2, 2 warmup steps) with the launch counts read around
   them, step 0's gradients held against the plain-version path (rtol
   1e-4) and bitwise equal across two runs; a Zipf trace served at
   k = 24, served == offline bitwise (full and cached passes); K6 held
   bitwise on every group of layer 1's aggregation and timed there, whole
   and group by group, with its bytes split, and K1 held bitwise and timed
   on the same groups' dense input; ``torch.topk`` per compress, the rotation
   copies of one aggregation at k = 96, 48, 24 and dense, and the step
   time at k = 24 and dense; K4 held bitwise and timed on every group of
   this plan at D = 96, as in phase 6;
13. the online tuner on the card, after phase 10 and on its graph and
   ring: (a) GCN 16 x 2 full-graph training under ``DynamicGNNEngine``
   (``H100_SXM``, budget 12, a window of 1 + 3 steps; ps 4/8/16/32 x
   dist 1/2/4 x pb 0 (K1)/4/8 (K2)) with the launch counts read around
   the search; each move's config, steps, rebuild seconds and whether K2
   launched, each probe's measured ms and model error, the committed
   config; (b) from the commit step, a static engine at the committed
   config gives the same losses and parameters bitwise for 3 steps, and
   the step time (CUDA events, 10 reps after 3) at the default ``ps=16,
   dist=2`` and at the committed config, there with pb 0 (K1), 4 and 8
   (K2); (c) a per-layer engine whose
   layers carry one config equals the single-plan engine bitwise (logits
   and one step's gradients), then a per-layer search (budget 16); (d)
   the device bytes the tuned engine held within 10 % of what a fresh
   static engine adds; (e) GCN serving of two Zipf phases with a hot-set
   rotation through a ``DynamicGNNEngine`` (ps 4/8/16 x dist 1/2 x pb
   0/4): at least one retune, and served == offline bitwise (full and
   cached passes) after it; (f) the sampled branch's search as the
   training launcher runs it (one idle ring plan; fanout 5/10 x batch
   512/1024, budget 4, SAGE 32 x 2 over the pinned tiered store at full
   size), each config's first K5 assembly bitwise ``x[ids]``; after (a)'s
   search, the hardware probes (``probe_hardware`` on the ring: fp32
   matmul rate, pageable H2D rate, one rotation's per-tile rate, each a
   number) and ``spec_from_probes(H100_SXM)``, and ``calibrate()`` on the
   search's audit trail, its calibrated model error at most the stock
   spec's.  The per-layer search and (e) run on the reduced stand-in
   (``TUNER_SCALE``): at full size a move's rebuild takes 5-7 s, and each
   retune's search makes several;
14. tiered serving and the streamed ring, after phase 13 and on phase 3's
   graph and features (2.45 M nodes, D = 100, 8 virtual shards, ps 16,
   dist 2, a pinned ``FeatureStore``): (a) the streamed ring at
   capacities 0, N // 8 and N (one pass each, launches counted; the top-k
   ring at k = D the same) bitwise equal across capacities, within 1e-5
   of the resident ``mgg_aggregate`` scaled by each row's sum of
   magnitudes ``A|x|`` (the sums associate differently; the entries
   outside elementwise rtol/atol 1e-5 are counted), the top-k ring at
   k = D bitwise the dense one, ``padded_table`` bitwise ``pad(x)`` and
   ``dist - 1`` prefetches a call; (b) each capacity's pass timed (CUDA
   events) beside the resident pass, the host bytes streamed, one pass's
   timeline from events on both streams (each ring, each upload, their
   overlap, the host's time in each fetch), the H2D rate, the pass's
   floor ``max(resident ms, streamed bytes / H2D rate)``, and, with the
   card held by a spin kernel, every prefetch returning before its ring
   ends (no fetch waits for the card); (c) K5 at the padded table's shape
   (capacity N // 8), bitwise its plain version and timed as in phase 8,
   ``index_select`` and its bound (the kernels line's K5 ``padded_table``);
   (d) a GCN serving trace with feature updates at capacity N // 8, its
   logits bitwise resident serving's on the same trace, full and cached
   passes alike; (e) the serving launcher with ``--feature-capacity`` and
   ``--trace``, its streamed profile's overlap efficiency;
15. the serving cluster, after phase 14: (a) at full width, phase 3's
   model and graph behind 4 static replicas (``ps=8, dist=1``), each its
   own engine over its own 8-shard virtual ring on the card (build
   seconds and device GB each), serving one Zipf trace of 200 requests
   with a hot-set rotation and 5 % feature updates through the locality
   router and through the least-load router (fresh serving engines over
   the same engines, launches counted): every request answered, every
   replica serving under the locality router, each answer bitwise the
   offline forward of the replica that served it over the features as
   they stood when its batch ran (full and cached passes); a cluster of
   one replica, with a tracer on the cluster and on the replica, bitwise
   ``run_trace`` on that replica untraced; K1 and K3 bitwise their plain
   versions on every group of a replica's plan; p50/p99 per router beside one replica on the same
   trace and phase 3's engine, and each replica's hit rate.  (b) The
   coordinated retune on the reduced stand-in (``TUNER_SCALE``): two
   ``DynamicGNNEngine`` replicas (ps 4/8/16 x dist 1/2 x pb 0/4,
   ``H100_SXM``) sharing one config cache and one metrics registry; a
   rotation trace through the locality router (at least one staggered
   retune, nothing dropped), then two overlapping drifts (the second
   replica adopts the first's commit with one measurement, fewer than the
   first's search), the counters the sums over the replicas, and served
   == offline bitwise after the rejoin, full and cached; (c) the serving
   launcher with ``--replicas 2 --router locality --dynamic-tune
   --feature-capacity --trace``, its merged trace passing
   ``repro_torch.obs.validate``;
16. the baselines at full width, on phase 14's graph and features (D =
   100, 8 shards, ps 16): ``bulk_aggregate`` and ``fetch_rows_aggregate``
   (pages of 1 and 16 rows), launches counted, each within 1e-5 of
   ``A|x|`` of the resident ``mgg_aggregate`` (ps 16, dist 2), K1, K3 and
   K5 bitwise their plain versions on every group of their plans, each
   timed (CUDA events) beside the resident ring with the rows it fetches
   and the bytes they are;
11. dense-LM inference at full width, after the GNN phases' device state
   is freed: mistral-nemo-12b (40 layers, d_model 5120, 32/8 heads,
   head_dim 128, vocab 131,072, fp32 parameters drawn on the card from a
   ``torch.Generator``).  (a) The cache-less forward at B = 2, S = 4096
   (``train_4k``'s length) with ``use_flash_attention`` (K7, one launch a
   layer, counted) against the chunked path: in fp32 compute the logits
   agree within rtol 2e-4, atol 2e-4 * max|logits|; in the configs' bf16
   compute the flag-on logits' rms error against the fp32 logits is at
   most 1.5 times the flag-off logits', and the largest difference and
   the share of equal argmaxes are printed; both forwards timed (CUDA events), the flag-on one profiled,
   and K7 timed at its shapes beside its plain version,
   ``scaled_dot_product_attention`` and its bound.  (b) ``prefill`` of
   512 tokens then ``decode_step`` against the forward of 513, fp32,
   within 2e-3.  (c) Serving: in fp32 compute, batched tokens equal solo
   tokens up to a step whose top-2 margin is under 1e-3 * max|logit|,
   and each request's batched logits equal its solo logits within rtol
   1e-4, atol 1e-4 * max|logit| at every step up to and including the
   first where the tokens part (all 16 when they never do; 16 new
   tokens a request); then the serving launcher at its defaults (8
   requests, 4 slots) but 16 new tokens (``--max-new``) with its own
   parameters, every request answered with 16 tokens, tokens/s, prefill
   and decode-step times.  (d) Ring TP on (a)'s
   parameters over a virtual (data 2, model 4) mesh (``dist/mesh.py``,
   every q/k/v/o and gate/up/down projection on the ring): the B 2 x S
   4096 flag-on forward in fp32 within rtol 2e-4, atol 2e-4 * max|logits|
   of (a)'s no-mesh forward (the reference's ring-vs-SPMD tolerance), in
   bf16 its rms error against those fp32 logits at most 1.5 x (a)'s
   flag-on bf16 forward's, K7 launched 40 times (counted); timed beside
   (a)'s no-mesh forward, with a timeline from CUDA events on both streams
   (each rotation copy on the side stream, each product on the current
   one, their overlap); the prefill of 512 takes the ring (within 2e-4 of
   the no-mesh prefill) and two decode steps from the same cache fall
   back, bitwise the no-mesh steps;
12. xlstm inference at full width, after phase 11's state is freed:
   xlstm-125m (12 layers alternating mLSTM/sLSTM, d_model 768, 4 heads,
   mLSTM d_in 1536 and dk 384, sLSTM hd 192, vocab 50,304 tied, fp32
   parameters drawn on the card from seed 0).  (a) The cache-less forward
   at B = 2, S = 4096 in the configs' bf16 compute (the main path, K8
   launches counted: one an sLSTM layer) and in fp32, both timed (CUDA
   events) and the bf16 one profiled; K8 held against its plain version on
   the card on every sLSTM layer's inputs of the fp32 forward (rtol = atol
   1e-4) and timed at those shapes beside the plain version and its bound,
   with its cluster size and shared memory a block, µs a step, every
   portable cluster size that fits timed in turns and held bitwise to the
   plan's, the cluster probe (the exchange of h alone, by K8's mbarriers
   and by a cluster barrier) µs a step, and a decode-shape launch (B 4,
   S 1).
   (b) ``prefill`` of 512 tokens then ``decode_step`` against the forward
   of 513, fp32, within 2e-3, and one decode step at the launcher's
   serving shape (4 slots, bf16) timed and profiled.  (c) In fp32 compute,
   batched tokens equal solo tokens under phase 11's top-2 margin rule,
   and batched logits equal solo logits step by step as in phase 11 (32
   new tokens); then the serving launcher as in phase 11 with ``--arch
   xlstm-125m``, K8 launches counted, every request answered with 16
   tokens, tokens/s, prefill and decode-step times.
17. LM training at full width, after phase 12's state is freed (K9 is
   also swept in phase 2: hd 8/16/64/192/256, H 1/2/4, B 1/3/8, S
   1/7/256 against autograd through the plain loop, rtol 1e-4 and atol
   1e-4 x the gradient's max |.|, with its bitwise invariants, and K8's
   save bitwise K8 without it).  (a) ``launch/train.py --arch xlstm-125m`` at
   its defaults (seq 256, batch 8, remat on, bf16 compute) for 30 AdamW
   steps, K8 and K9 launches counted (12 and 6 a step), the loss of the
   last 5 steps below the first 5's, each step's ms and the peak GB;
   (b) step 0's gradients (fp32 compute, no remat) with K8/K9 against
   the plain loop under autograd on the card, leaf by leaf within rtol
   2e-4, atol 2e-4 x max|leaf|, and K9 held against its plain version on
   every sLSTM layer's inputs and gradients of that step; (c) a step at
   B x S = 2 x 4096, timed (CUDA events, host clock) and profiled (device
   ms by kind: K8, K9, matrix products, the rest), its parts timed
   alone, and K9 at one layer's shapes beside its plain version, its
   bound, its rows a cluster, every cluster size, its exchange alone (the
   backward cluster probe) and the launcher's shape (B 8, S 256), held
   within 1e-3 of each gradient's rms;
   (d) 12 steps with a failure injected at step 8 and checkpoints every
   5 (one restart, the last checkpoint step 10), traced losses bitwise
   the untraced ones over 5 steps, and accumulation over 4 microbatches
   against 1 (fp32 compute, rtol 2e-4, atol 2e-5); (e)
   ``launch/train_lm.py --tune-accum`` for 24 steps, the tuner's moves
   and result; (f) one AdamW step of mistral-nemo-12b at full width with
   its depth cut to 2 layers, B 1, S 4096, bf16, flash off: a finite
   loss, the step ms and peak GB, no kernel launched.
18. the moe and hybrid families at full width, after phase 17's state is
   freed, parameters drawn on the card from seed 0.  (a)
   granite-moe-1b-a400m as published (24 layers, d_model 1024, 16/8
   heads of 64, 32 experts top-8, d_ff 512, vocab 49,155 tied): the B =
   2 x S = 4096 forward with ``use_flash_attention`` (K7, 24 launches,
   counted) against the chunked path, in fp32 within rtol 2e-4, atol
   2e-4 * max|logits| up to the first token whose routing differs
   between the two (an fp32 near-tie of router logits; every token when
   none does, the count reported), in bf16 the flag-on rms error against
   the fp32 logits at most 1.5 x the flag-off one's; timed, profiled
   (device ms by kind: K7, routing and sort, the dispatch and combine
   gathers, matrix products, the rest) and one layer's parts timed
   alone; ``prefill`` of 512 + ``decode_step`` against the forward of
   513 at no-drop capacity, fp32, within 2e-3; the serving launcher as
   in phase 11; ``launch/train.py`` at its defaults for 15 steps, the
   last 5 losses below the first 5, and one step from the trained state
   run twice: loss and every gradient bitwise equal.  (b) zamba2-7b as
   published (81 layers: 13 groups of 6 mamba blocks each followed by
   the shared attention block, a tail of 3; d_model 3584, 112 SSM heads
   of 64, state 64, attention hd 112, window 4096): the same forward
   checks with 13 K7 launches, profiled and one mamba block's parts
   timed (the SSD chunk loop, the projections) with the shared block;
   prefill + decode (fp32, within 2e-3); batched == solo tokens and
   logits as in phase 11 (c) (16 new tokens); the serving launcher;
   training at its
   depth cut to 13 layers (2 groups and a tail of 1; AdamW's state for
   6.6 B parameters does not fit one card), full width: step 0's
   gradients at seq 256 (chunk 256) every one finite and bitwise across
   two runs, then the launcher for 10 steps with the loss falling.  (c)
   mixtral-8x7b at full width with its depth cut to 2 layers: the 2 x
   4096 forward flag on (2 K7 launches) against off in fp32, as (a);
   one AdamW step at B 1, S 4096, bf16, cut to 1 layer (at 2 the step
   holds 7 x 12.66 GB of parameters, gradients and moments, over the
   card's 80 GB): a finite loss, the step ms and peak GB.  (d) K7 at
   (a)'s and (b)'s layer shapes beside its plain version, SDPA and its
   bound (K7's kernels entry, ``at_granite`` and ``at_zamba2``).
19. whisper-base (the encdec family) as published, after phase 18's
   state is freed: 6 encoder and 6 decoder layers, d_model 512, 8 heads
   of 64, d_ff 2048, vocab 51,865 tied, parameters fp32 drawn on the card
   from seed 0, frames a (B, 1500, 512) normal batch (the stub
   frontend's output), 448 tokens.  (a) the forward (encoder, then the
   teacher-forced decoder) at B 8 with ``use_flash_attention`` (K7, 12
   launches counted: the encoder's 6 causal off, the decoder's 6
   self-attentions causal; cross attention takes the chunked path) and
   without: every K7 call of the bf16 flag-on forward held to its plain
   version on the same inputs, and the flag-on forward held to its twin
   with K7's plain version in K7's place (fp32 within rtol 2e-4, atol
   2e-4 * max|logits|; bf16 K7's rms error against the fp32 twin at
   most 1.5 x the bf16 twin's) -- the flag-off forward is no reference,
   its encoder being causal (ROADMAP §3 F3), which is pinned here: a
   change to frame 1499 leaves frames 0-1498 of the flag-off encoder
   bitwise unchanged and moves them with the flag on; timed and
   profiled (device ms by kind); (b) K7 at the encoder's shape (B 8, S
   1500, H = KV = 8, hd 64, causal off) beside its plain version, SDPA
   (``is_causal=False``) and its bound (K7's ``at_whisper``); (c)
   ``prefill`` of the 1500 frames and a 4-token prompt then 28 greedy
   ``decode_step``s at B 4, fp32, flag off: every step's logits within
   2e-3 of the teacher-forced forward over the generated tokens, a
   second run the same tokens, the ms of a decode step; the flag-on
   bf16 prefill launches K7 6 times (counted); (d) 10 AdamW steps
   through ``train/trainer.py`` (``Trainer``, ``make_train_step``) at B 8
   x 1500 frames x 448 tokens, bf16 compute, remat, flag off: the loss
   falling from about ln(51,865), step ms and peak GB, and step 0's fp32
   loss and gradients bitwise equal across two runs, every one finite.
20. the distributed substrate on granite-moe-1b-a400m at full width, after
   phase 19's state is freed: a virtual (data 2, model 4) mesh, ring TP in
   attention and EP in every MoE layer (8 of the 32 experts a shard; at B
   2 x S 4096 each shard routes 1024 tokens at capacity 320).  (a) The
   fp32 flag-on forward (chunks 1) within rtol 2e-4, atol 2e-4 *
   max|logits| of its oracle (``moe_apply`` with all 32 experts on each
   shard's own token block at that block's capacity), of chunks 4 and of
   ring TP off, every routing replayed from the first forward's ids (a
   differing id only at an fp32 near-tie: its logit gap under 1e-4 *
   max|logit|, counted); (b) bf16 at chunks 1 and 4 (K7 24 launches each,
   counted), their rms error against the fp32 forward at most 1.5 x the
   bf16 oracle's; timed beside ring TP off and no mesh, with timelines of
   the rotations, the EP exchanges and their overlap with the products
   and the expert FFN; (c) prefill 512 + decode against the forward at
   no-drop capacity, within 2e-3; (d) step 0's fp32 gradients (B 2, S
   1024, no-drop, remat) on the mesh within rtol 2e-4, atol 2e-4 *
   max|leaf| of no mesh (the routing replayed from the mesh step's), then
   10 AdamW steps through ``make_train_step`` on the mesh (B 2, S 512,
   bf16, chunks 4), the loss falling; (e) the launcher with ``--devices 4
   --ef-bits 8 --ring-tp --moe-pipeline-chunks 4`` for 10 steps (ef on a
   pure data-parallel mesh, EP at ep 1, ring TP falling back): its step-0
   loss bitwise the same launcher's without ``--ef-bits``, its residual
   nonzero, and the ef pass over its gradients timed.

21. the dry-run counts held on the card, after phase 20 (at most 30 s;
   its meta cells trace in a process of their own, started after phase 1,
   so their CPU seconds hide behind the card's phases): (a) phase 3's
   served pass (one full pass, two aggregations at D = 16), counted live
   under ``launch/op_cost.py`` while phase 3's engine was on the card: its
   rotation bytes equal ``launch/dryrun_gnn.py``'s count of the same plan
   on meta and ``collective_bytes`` a shard x 8 x 2, its K1/K3 launches
   and bytes the host plan's work (``kernels/cost.py`` on the plan's
   index arrays), exactly; (b) phase 11's mistral-nemo-12b bf16 flag-on 2
   x 4096 forward counted on meta: its dot flops equal, as integers, the
   same counter's on phase 11's live forward on the card, its K7 records
   40 x 274945015808 flops, and ``forward_mfu`` (counted flops / phase
   11's timed forward / the card's bf16 peak) printed; (c) the reference's
   ``tests/multidev/dryrun_lite.py`` cells (granite-moe-1b-a400m train_4k,
   xlstm-125m decode_32k, whisper-base prefill_32k) at full width on a
   (2, 2) meta mesh: flops > 0, the train cell's collectives > 0, each
   cell's seconds; (d) xlstm-125m train_4k on one shard: its parameters'
   and AdamW state's argument bytes equal phase 17's on the card.  Every
   kernel's ``bytes``/``flops`` in the kernels line comes from
   ``kernels/cost.py``, the functions the counters record with.

Phase 6's GCN engine (ps 16, dist 2) is built once and serves phases 13
(b), 14 and 16, whose plans it equals.

The line before the last is a JSON object of the kernels K1–K9; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
T0 = time.perf_counter()
# what phase 21 holds on the card: the counts and bytes phases 3, 11 and 17
# took live, while their state was on the card
DRY = {}

CARD_RATES = [  # (name fragments, bytes/s): NVIDIA data sheets, dense
    (("H200",), 4.8e12),
    (("H100", "PCIE"), 2.0e12),
    (("H100", "NVL"), 3.9e12),
    (("H100",), 3.35e12),    # SXM (HBM3)
]
SOURCE = {name: "src/repro_torch/kernels/csrc/gather_sum.cu" for name in (
    "gather_sum_pipelined", "gather_sum_blocked", "segment_add_ordered",
    "scatter_sum_ordered")}
SOURCE["gather_rows"] = "src/repro_torch/kernels/csrc/rows.cu"
SOURCE["sparse_gather_sum"] = \
    "src/repro_torch/kernels/csrc/sparse_gather_sum.cu"
SOURCE["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE["slstm_scan"] = "src/repro_torch/kernels/csrc/slstm_scan.cu"
SOURCE["slstm_scan_backward"] = SOURCE["slstm_scan"]
CARD_FLOPS = [  # (name fragments, {input dtype: flop/s}): NVIDIA data
    # sheets, dense; bf16 on the tensor cores, fp32 outside them
    (("H200",), {"bfloat16": 989e12, "float32": 67e12}),
    (("H100", "PCIE"), {"bfloat16": 756e12, "float32": 51e12}),
    (("H100", "NVL"), {"bfloat16": 835e12, "float32": 60e12}),
    (("H100",), {"bfloat16": 989e12, "float32": 67e12}),    # SXM
]
REPLACES = {
    "gather_sum_pipelined": "src/repro/kernels/neighbor_agg.py:77",
    "gather_sum_blocked": "src/repro/kernels/neighbor_agg.py:209",
    # no Pallas kernel: the per-step scatter-add of the ring
    "segment_add_ordered": "src/repro/core/pipeline.py:313",
    # no Pallas kernel: the gather-sum's custom-VJP backward
    "scatter_sum_ordered": "src/repro/kernels/ops.py:76",
    "gather_rows": "src/repro/kernels/rows.py:31",
    "sparse_gather_sum": "src/repro/kernels/neighbor_agg.py:142",
    "flash_attention": "src/repro/kernels/flash_attention.py:79",
    "slstm_scan": "src/repro/kernels/slstm_scan.py:83",
    # no Pallas kernel: the reference differentiates the scan by autodiff
    "slstm_scan_backward": "no Pallas kernel: autodiff of lax.scan, "
                           "src/repro/models/xlstm.py:230",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "serving": ("gather_sum_pipelined", "gather_sum_blocked",
                "segment_add_ordered"),
    "training": ("gather_sum_pipelined", "segment_add_ordered",
                 "scatter_sum_ordered"),
    "sampled": ("gather_sum_pipelined", "scatter_sum_ordered",
                "gather_rows"),
    # the top-k ring: 10 training steps, then a served trace
    "sparse": ("gather_sum_pipelined", "segment_add_ordered",
               "scatter_sum_ordered", "sparse_gather_sum"),
    "sparse_serving": ("gather_sum_pipelined", "segment_add_ordered",
                       "sparse_gather_sum"),
    # phase 13: the tuner's search over GCN training steps (K2 with pb set)
    "tuner": ("gather_sum_pipelined", "gather_sum_blocked",
              "segment_add_ordered", "scatter_sum_ordered"),
    # phase 13 (e): serving with drift retuning
    "tuner_serving": ("gather_sum_pipelined", "segment_add_ordered"),
    # phase 13 (f): the sampled branch's fanout / batch search
    "tuner_sampled": ("gather_sum_pipelined", "scatter_sum_ordered",
                      "gather_rows"),
    # phase 14: the streamed ring over the tiered store, dense and top-k,
    # then tiered serving
    "tiered": ("gather_sum_pipelined", "segment_add_ordered", "gather_rows"),
    "tiered_sparse": ("sparse_gather_sum", "segment_add_ordered",
                      "gather_rows"),
    "tiered_serving": ("gather_sum_pipelined", "segment_add_ordered",
                       "gather_rows"),
    # phase 15: the serving cluster at full width (two routers), and the
    # coordinated retune of two tuned replicas
    "cluster_serving": ("gather_sum_pipelined", "segment_add_ordered"),
    "cluster_retune": ("gather_sum_pipelined", "segment_add_ordered"),
    # phase 16: the baselines
    "bulk_baseline": ("gather_sum_pipelined", "segment_add_ordered"),
    "fetch_baseline": ("gather_rows", "gather_sum_pipelined",
                       "segment_add_ordered"),
    # the LM's cache-less forward with use_flash_attention (bf16 compute)
    "lm_forward": ("flash_attention",),
    # xlstm-125m: the cache-less forward (bf16 compute), then the launcher
    "xlstm_forward": ("slstm_scan",),
    "xlstm_serving": ("slstm_scan",),
    # xlstm-125m training through the launcher: K8 forward (twice a step
    # with remat) and K9 backward on every sLSTM layer
    "lm_training": ("slstm_scan", "slstm_scan_backward"),
    # phase 18: the flag-on forwards of granite-moe-1b-a400m and zamba2-7b
    # (bf16 compute) and of mixtral-8x7b cut to 2 layers (fp32)
    "moe_forward": ("flash_attention",),
    "hybrid_forward": ("flash_attention",),
    "mixtral_forward": ("flash_attention",),
    # phase 19: whisper-base's flag-on forward (bf16 compute: the encoder's
    # layers causal off, the decoder's self-attentions causal) and its
    # flag-on prefill (the encoder's layers)
    "whisper_forward": ("flash_attention",),
    "whisper_prefill": ("flash_attention",),
    # phase 11 (d): mistral-nemo-12b's bf16 flag-on forward with ring TP
    # over the virtual (2, 4) mesh; phase 20: granite-moe-1b-a400m's with
    # ring TP and EP over it, at EP pipeline chunks 1 and 4
    "ring_tp_forward": ("flash_attention",),
    "moe_mesh_forward_chunks1": ("flash_attention",),
    "moe_mesh_forward_chunks4": ("flash_attention",),
}
PRODUCTS_SCALE = 199.3   # 12288 · 199.3 ≈ 2.449 M nodes (ogbn-products)
REDUCED_SCALE = 10.0     # 122,880 nodes: GIN, SAGE and GAT, one step each
# fig9e (benchmarks/fig9_ablations.py:134-229): GCN 3 x D, D = 96
SPARSE_D, SPARSE_CLASSES, SPARSE_KS = 96, 4, (96, 48, 24)
TRAIN_STEPS = 10
TOL_PLAIN = "rtol 1e-4, atol 1e-4 * max|leaf|"
TOL_FUSED = "rtol 2e-4, atol 2e-4 * max|leaf|"
# phase 11: mistral-nemo-12b, B x S = 2 x 4096 (train_4k's length)
LM_ARCH, LM_B, LM_S, LM_PREFIX = "mistral-nemo-12b", 2, 4096, 512
# K7 sweep: the reference's five cases (tests/test_kernels_flash.py:32-39;
# (B, S, H, KV, causal, window), run at each head_dim K7 takes)
FLASH_REF_CASES = [(2, 64, 4, 4, True, 0), (1, 128, 8, 2, True, 0),
                   (2, 96, 4, 1, True, 32), (1, 50, 2, 2, True, 0),
                   (1, 64, 4, 4, False, 0)]
# phase 12: xlstm-125m, B x S = 2 x 4096 (train_4k's length)
XL_ARCH, XL_B, XL_S, XL_PREFIX = "xlstm-125m", 2, 4096, 512
SLSTM_TOL = 1e-4    # K8 against its plain version, rtol = atol
LOGIT_TOL = 1e-4    # batched against solo logits, each step (fp32)
# phase 11 (a), bf16: the flag-on forward's rms error against the fp32
# logits, at most this times the flag-off (chunked) forward's
BF16_RMS_RATIO = 1.5
# K8 sweep: head_dim, heads, batch rows, steps (each combination)
SLSTM_SWEEP = ((8, 16, 64, 192), (1, 2, 4), (1, 3, 8), (1, 7, 256, 4096))
# K9 sweep: the same but S 4096 (the plain version is autograd through
# the loop) and with hd 256 (wr's rows in registers, 32 float4s a thread),
# and its tolerance against the plain version: rtol K9_TOL,
# atol K9_TOL x the tensor's max |.| at S <= 256; at S = 4096 each
# tensor's rms difference within K9_RMS_TOL of its rms (K8's forward is
# already within 1e-4 of the plain loop's, and the recurrence carries
# that through S steps both ways)
SLSTM_BWD_SWEEP = ((8, 16, 64, 192, 256), (1, 2, 4), (1, 3, 8),
                   (1, 7, 256))
K9_TOL = 1e-4
K9_RMS_TOL = 1e-3
# phase 17: LM training, xlstm-125m at full width through the launcher at
# its defaults (seq 256, batch 8, remat on, bf16 compute); step 0's
# gradients with K8/K9 against the plain loop under autograd (fp32
# compute, rtol and atol x max|leaf| TRAIN_GRAD_TOL); a step at train_4k's
# length; the dense family one step at full width, cut to 2 layers
TRAIN_ARCH, TRAIN_LM_STEPS, TRAIN_GRAD_TOL = "xlstm-125m", 30, 2e-4
TRAIN_4K_B, TRAIN_4K_S = 2, 4096
# the LM serving launcher's new tokens a request (its default is 32) and
# batched == solo's, on mistral-nemo-12b and zamba2-7b (32 on xlstm-125m):
# decode depth cut for the card run's time, every request still checked
LM_SERVE_NEW, LM_BVS_NEW = 16, 16
DENSE_TRAIN_ARCH, DENSE_TRAIN_LAYERS = "mistral-nemo-12b", 2
# phase 18: the moe and hybrid families, B x S = 2 x 4096 forwards, prefill
# of 512 + decode; zamba2 trained at full width with its depth cut to 2
# groups of 6 and a tail of 1 (AdamW's state for 6.6 B parameters does not
# fit one card); mixtral-8x7b's forward cut to 2 layers, its AdamW step to 1
MOE_ARCH, HYB_ARCH, MIX_ARCH = ("granite-moe-1b-a400m", "zamba2-7b",
                                "mixtral-8x7b")
P18_B, P18_S, P18_PREFIX = 2, 4096, 512
HYB_TRAIN_LAYERS, HYB_TRAIN_STEPS = 13, 10
# granite's steps through the training launcher (its loss falls by step 5)
MOE_TRAIN_STEPS = 15
MIX_LAYERS, MIX_TRAIN_LAYERS = 2, 1
# phase 19: whisper-base at its published widths and depth, frames of the
# stub frontend's N_FRAMES (1500) and 448 tokens (the most Whisper
# decodes): forwards and training at B 8, prefill of a 4-token prompt and
# greedy decode steps at B 4
W_ARCH, W_B, W_TOKENS = "whisper-base", 8, 448
W_DEC_B, W_PROMPT, W_DECODE_STEPS = 4, 4, 28
W_TRAIN_STEPS = 10
# phases 11 (d) and 20: the virtual (data, model) mesh; phase 20's
# granite-moe-1b-a400m forwards at B x S, its step-0 gradient check's
# length (fp32 at no-drop capacity), its AdamW steps' length, their count,
# and the EP exchange's pipeline chunks
MESH_SHAPE = (2, 4)
P20_B, P20_S, P20_GRAD_S, P20_TRAIN_S, P20_STEPS = 2, 4096, 1024, 512, 10
P20_CHUNKS = (1, 4)
# phase 20 (e): the ef launcher's granite, its depth cut (full width)
P20_EF_LAYERS = 16
# K5 at the sampled step's shape: a median over this many timed calls, and
# the spin (cycles, ~10 ms) that holds the stream while they are enqueued
K5_MEDIAN_CALLS = 25
K5_HOLD_CYCLES = 20_000_000
# K5 sweep: widths of every path (words, 16-byte vectors, vpr > THREADS)
K5_SWEEP_D = (1, 3, 4, 100, 128, 130, 257)
# K1 and K6 sweeps: more partitions than one grid of K1 holds (what fits
# the card at once), so each of its warps walks several
GRID_P = 300_000
# phase 13: the tuner's spaces (pb 0 is K1, pb 4 and 8 K2), its budget of
# measurements, and the scale of its per-layer search and serving run
TUNER_PS, TUNER_DIST, TUNER_PB = (4, 8, 16, 32), (1, 2, 4), (0, 4, 8)
TUNER_BUDGET = 12
TUNER_SCALE = REDUCED_SCALE
# phase 13 (f): the sampled branch's spaces (the launcher's f, 2f and b, 2b)
SAMPLED_FANOUT, SAMPLED_BATCH = (5, 10), (512, 1024)
# phase 14: the streamed ring's plan on the full stand-in
STREAM_PS, STREAM_DIST = 16, 2
# phase 6's GCN engine at (STREAM_PS, STREAM_DIST) on the full stand-in and
# the shared ring, built once: phases 13 (b), 14 and 16 take the same plan
# and device arrays (freed before phase 11)
SHARED = {}
# phase 15: replicas of phase 3's engine, and the requests of their trace
# (the hot set rotates after half of them)
CLUSTER_REPLICAS, CLUSTER_REQUESTS = 4, 200
# phase 16: the fetch baseline's page sizes (rows)
BASELINE_PAGES = (1, 16)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def held(got, want, what):
    """Hold a kernel's output to its plain version (rtol/atol 1e-5);
    returns the largest absolute difference."""
    check(got.shape == want.shape
          and got.allclose(want, rtol=1e-5, atol=1e-5),
          f"{what}: disagrees with its plain version")
    return (got - want).abs().max().item()


def say(phase, **kw):
    """A phase's line; ``t_s`` is the seconds since the run began."""
    print(json.dumps(dict(phase=phase, **kw, t_s=round(
        time.perf_counter() - T0, 1)), default=str), flush=True)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from the repository")
    sys.path.insert(0, SRC)

    import repro_torch.core as C
    import repro_torch.kernels as K
    from repro_torch.core.pipeline import mgg_aggregate
    from repro_torch.dist import VirtualRing
    from repro_torch.kernels import _build, neighbor_agg, ops, ref
    from repro_torch.launch import serve_gnn
    from repro_torch.serve import (GNNServeEngine, TrafficPhase,
                                   WorkloadStats, ZipfTraffic, run_trace)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rate = next((r for frags, r in CARD_RATES
                 if all(f in name.upper() for f in frags)), None)
    check(rate is not None, f"no memory rate on record for {name}")
    flops = next((r for frags, r in CARD_FLOPS
                  if all(f in name.upper() for f in frags)), None)
    check(flops is not None, f"no flop rate on record for {name}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    sass, n_fn = flash_tc_sass(_build)
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"K7's bf16 kernel holds no wgmma or no TMA load: {sass}")
    cells = start_dry_run_cells()
    say("environment", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=name,
        kernel_build_s=round(build_s, 3), nvcc_s=_build.build_seconds,
        peak_bytes_per_s=rate, peak_flops=flops,
        flash_bf16_sass=dict(functions=n_fn, **sass))

    # -- 2. kernels against their plain versions ---------------------------
    gen = np.random.default_rng(0)
    n_cases, worst = 0, 0.0
    for d in (1, 16, 100, 130, 602):
        for ps in (1, 8, 16, 40):      # 40: K1 takes 8 slots a batch
            # 37, 1000: not multiples of pb; 300,000: more partitions than
            # one grid of K1 holds, so its warps walk several
            for p in (1, 37, 1000, GRID_P):
                for all_masked in (False, True):
                    t = 3000
                    buf = torch.from_numpy(gen.normal(size=(t, d)).astype(
                        np.float32)).to(dev)
                    nbrs = torch.from_numpy(gen.integers(
                        0, t, (p, ps)).astype(np.int32)).to(dev)
                    mask = torch.from_numpy(
                        np.zeros((p, ps), bool) if all_masked
                        else gen.random((p, ps)) < 0.8).to(dev)
                    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
                    for pb in (None, 1, 4, 8):
                        got = ops.neighbor_gather_sum(buf, nbrs, mask, pb=pb)
                        again = ops.neighbor_gather_sum(buf, nbrs, mask,
                                                        pb=pb)
                        worst = max(worst, held(
                            got, want,
                            f"gather-sum D={d} ps={ps} P={p} pb={pb}"))
                        check(torch.equal(got.view(torch.int32),
                                          want.view(torch.int32)),
                              f"gather-sum D={d} ps={ps} P={p} pb={pb}: "
                              "not bitwise its plain version")
                        check(torch.equal(got, again),
                              f"gather-sum not bitwise stable D={d} pb={pb}")
                        n_cases += 1
    for d in (1, 16, 100, 602):
        rows, p = 500, 20000
        tgt = np.concatenate([np.sort(gen.zipf(1.5, p - 64) % rows),
                              np.zeros(64, np.int64)])  # padded tail
        grp = C.WorkGroup.build(np.zeros((p, 1)), np.ones((p, 1), bool), tgt,
                                dev)
        partial = torch.from_numpy(gen.normal(size=(p, d)).astype(
            np.float32)).to(dev)
        out0 = torch.from_numpy(gen.normal(size=(rows, d)).astype(
            np.float32)).to(dev)
        check(grp.chunks is not None, "the Zipf targets hold no hub")
        segs = (grp.order, grp.seg_rows, grp.seg_start, grp.chunks)
        want = ref.segment_add_ordered_ref(out0.clone(), partial, *segs)
        got = ops.segment_add_ordered(out0.clone(), partial, *segs)
        again = ops.segment_add_ordered(out0.clone(), partial, *segs)
        worst = max(worst, held(got, want, f"segment add D={d}"))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"segment add D={d} not bitwise its plain version")
        check(torch.equal(got, again), f"segment add not bitwise D={d}")
        n_cases += 1
    for d in (1, 16, 100, 130):          # K4: the gather-sum's backward
        for ps, p, t in ((1, 1, 50), (8, 37, 3000), (16, 20000, 3000)):
            nb = gen.integers(0, t, (p, ps))
            nb[: p // 3, 0] = 7                     # a hub row
            mk = gen.random((p, ps)) < 0.8
            mk[1::5] = False                        # all-masked partitions
            nb[~mk] = t - 1            # masked slots name a sentinel row
            nb[mk & (nb == t - 1)] = 0
            tgt = gen.integers(0, 500, p)
            idx = ops.GradIndex.build(nb, mk, tgt, dev)
            g_out = torch.from_numpy(gen.normal(size=(500, d)).astype(
                np.float32)).to(dev)
            base = torch.from_numpy(gen.normal(size=(t, d)).astype(
                np.float32)).to(dev)
            args = (g_out, idx)
            want = ref.scatter_sum_ordered_ref(base.clone(), *args)
            got = ops.scatter_sum_ordered(base.clone(), *args)
            again = ops.scatter_sum_ordered(base.clone(), *args)
            worst = max(worst, held(got, want, f"scatter-sum D={d} P={p}"))
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"scatter-sum D={d} P={p}: not bitwise its plain version")
            check(torch.equal(got, again), f"scatter-sum not bitwise D={d}")
            check(torch.equal(got[-1], base[-1]),
                  f"scatter-sum D={d}: the sentinel row got a gradient")
            n_cases += 1
    t_k5 = time.perf_counter()
    n_cases += sweep_gather_rows(torch, K, ref, dev, gen)
    k5_sweep_s = time.perf_counter() - t_k5
    for d in (1, 13, 96, 130, 600):      # K6: every register-batch path
        for k in sorted({1, max(1, d // 4), d}):
            for id_dtype in (torch.int16, torch.int32):
                for p, ps in ((1, 1), (37, 8), (1000, 8), (GRID_P, 40)):
                    t = 3000
                    x = torch.from_numpy(gen.normal(size=(t, d)).astype(
                        np.float32)).to(dev)
                    vals, idx = C.topk_activation(x, k)
                    idx = idx.to(id_dtype)
                    nb = gen.integers(0, t, (p, ps))
                    nb[: p // 3] = 11                   # a hub row
                    mk = gen.random((p, ps)) < 0.8
                    mk[1::5] = False                    # all-masked
                    nbrs = torch.from_numpy(nb.astype(np.int32)).to(dev)
                    mask = torch.from_numpy(mk).to(dev)
                    want = ref.sparse_gather_sum_ref(vals, idx, nbrs, mask,
                                                     d)
                    got = ops.sparse_neighbor_gather_sum(
                        vals, idx, nbrs, mask, d_feat=d)
                    again = ops.sparse_neighbor_gather_sum(
                        vals, idx, nbrs, mask, d_feat=d)
                    check(torch.equal(got.view(torch.int32),
                                      want.view(torch.int32))
                          and torch.equal(got, again),
                          f"sparse gather-sum D={d} k={k} {id_dtype} P={p}"
                          " not bitwise its plain version")
                    n_cases += 1
    # the sweeps' last cases hold GBs that no later phase may keep
    del buf, x, vals, idx, nbrs, mask, want, got, again
    torch.cuda.empty_cache()
    flash_cases, flash_err, flash_row = sweep_flash(torch, ops, ref, dev, gen)
    n_cases += flash_cases
    slstm_cases, slstm_err = sweep_slstm(torch, ops, ref, K, dev, gen)
    n_cases += slstm_cases
    k9_cases, k9_err, k9_rel = sweep_slstm_backward(torch, ops, ref, K, dev,
                                                    gen)
    n_cases += k9_cases
    say("kernels_vs_plain", cases=n_cases, max_abs_err=worst,
        tolerance="rtol 1e-5 atol 1e-5; K1-K6 bitwise",
        k5_sweep_s=round(k5_sweep_s, 3),
        flash_cases=flash_cases, flash_max_abs_err=flash_err,
        flash_bf16_max_row_rms_ratio=flash_row,
        flash_tolerance="fp32 rtol 2e-5 atol 2e-5, bf16 rtol 1e-2 atol 1e-2 "
                        f"and each row's rms within {FLASH_ROW_RTOL}",
        slstm_cases=slstm_cases, slstm_max_abs_err=slstm_err,
        slstm_tolerance=f"rtol {SLSTM_TOL} atol {SLSTM_TOL}",
        slstm_bitwise=["row alone == row in its batch at bt 1, 3, 8",
                       "one launch over S == two with the state carried",
                       "two launches equal"],
        slstm_backward_cases=k9_cases, slstm_backward_max_abs_err=k9_err,
        slstm_backward_max_err_over_max=k9_rel,
        slstm_backward_tolerance=f"rtol {K9_TOL}, atol {K9_TOL} x max|.| "
                                 "of each gradient",
        slstm_backward_bitwise=[
            "row alone == row in its batch",
            "bt 1 == bt 8 == the plan's rows (bwd_rows)",
            "one launch over S == the last steps then the first with the "
            "gradients carried", "two launches equal",
            "K8 with its save == K8 without (hs and states)"],
        bitwise_relaunch=True)

    # -- 3. the main path at full width ------------------------------------
    t0 = time.perf_counter()
    g, meta = C.paper_dataset("products", scale=PRODUCTS_SCALE, seed=0)
    d_in, ncls = int(meta["dim"]), int(meta["classes"])
    x = np.random.default_rng(0).normal(
        size=(g.num_nodes, d_in)).astype(np.float32)
    ring = VirtualRing(8, dev)
    init, apply, kw = C.MODEL_ZOO["gcn"]
    params = init(torch.Generator().manual_seed(0), d_in, ncls,
                  device=dev, **kw)
    eng = C.GNNEngine.build(g, ring, ps=8, dist=1)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=8,
                         stats=WorkloadStats(window=32))
    t_build = time.perf_counter() - t0
    say("main_path_built", nodes=g.num_nodes, edges=g.num_edges,
        edges_with_self_loops=srv.g_full.num_edges, d_in=d_in, classes=ncls,
        shards=ring.n_dev, config=eng.config, build_s=round(t_build, 3),
        gpu_mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    phases = [TrafficPhase(requests=200, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.02),
              TrafficPhase(requests=200, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.02)]
    events = list(ZipfTraffic(g.num_nodes, d_in, phases, seed=0))
    n_requests = sum(not ev.is_update for ev in events)
    lay0 = eng.ring_arrays[0]

    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = run_trace(srv, events)
    with torch.inference_mode():      # the pb knob of the dynamic engine
        h0 = srv.xp @ params["layers"][0]["w"]
        h_pb = mgg_aggregate(h0, eng.plan, ring, pb=4, arrays=lay0)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {"serving": K.launch_counts()}
    check(all(launches["serving"][k] > 0 for k in PATH_KERNELS["serving"]),
          f"a kernel of the serving path never launched: {launches}")
    lat = np.array([r.latency for r in results])
    rep = srv.report()
    check(n_requests > 0 and len(results) == rep["served"] == n_requests
          and sorted(r.request_id for r in results) == list(range(n_requests)),
          f"{n_requests} requests in the trace, {len(results)} answered")
    say("main_path_served", requests=len(results), batches=rep["batches"],
        cached_requests=int(sum(r.cached for r in results)),
        p50_ms=float(np.percentile(lat, 50) * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
        cache_hit_rate=rep["cache_hit_rate"],
        cache_invalidations=rep["cache_invalidations"],
        serve_s=round(t_serve, 3), launches=launches["serving"])
    check(all(np.isfinite(r.logits).all() and r.logits.shape ==
              (r.seeds.size, ncls) for r in results), "bad served logits")

    # served == offline, bitwise, through a full and a cached pass
    seeds = np.unique(np.concatenate([r.seeds for r in results[:3]]))[:8]
    srv.cache.invalidate()
    srv.submit(seeds)
    (full,) = srv.step()
    srv.submit(seeds)
    (cached,) = srv.step()
    check(not full.cached and cached.cached, "full/cached passes not taken")
    with torch.inference_mode():
        offline = apply(params, eng, srv.xp)
        plain = apply(params, dataclasses.replace(eng, use_kernel=False),
                      srv.xp)
    rows = torch.from_numpy(C.pgas_rows(eng.plan, seeds).astype(np.int64))
    off_rows = offline[rows.to(dev)].cpu().numpy()
    check(np.array_equal(full.logits, off_rows), "full pass != offline")
    check(np.array_equal(cached.logits, off_rows), "cached pass != offline")
    sample = torch.from_numpy(np.random.default_rng(1).choice(
        eng.plan.padded_nodes, min(4096, eng.plan.padded_nodes),
        replace=False)).to(dev)
    check(torch.allclose(offline[sample], plain[sample], rtol=2e-4,
                         atol=1e-5), "kernel path != plain path")
    check(np.allclose(cached.logits, plain[rows.to(dev)].cpu().numpy(),
                      rtol=2e-4, atol=1e-5), "served != plain path")
    with torch.inference_mode():      # K2's aggregation, on the same arrays
        h_k1 = mgg_aggregate(h0, eng.plan, ring, arrays=lay0)
        err_pb = max(
            held(h_pb, h_k1, "pb=4 aggregation against pb=None"),
            held(h_pb, mgg_aggregate(h0, eng.plan, ring, use_kernel=False,
                                     arrays=lay0),
                 "pb=4 aggregation against the plain path"))
        check(torch.equal(h_pb, h_k1),
              "pb=4 aggregation not bitwise the pb=None one")
        del h_k1
    say("main_path_checked", served_equals_offline="bitwise (full, cached)",
        plain_max_abs_err=float((offline[sample] - plain[sample]).abs()
                                .max()),
        tolerance_plain="rtol 2e-4 atol 1e-5", pb4_max_abs_err=err_pb,
        tolerance_pb4="rtol 1e-5 atol 1e-5 against the plain path, "
                      "bitwise the pb=None aggregation")

    # phase 21 (a)'s live count: one full served pass under the counter,
    # and the plan (on the host, its device arrays moved to meta) it ran
    from repro_torch.launch import dryrun_gnn, op_cost
    srv.cache.invalidate()
    srv.submit(seeds)
    t_dry = time.perf_counter()
    live = op_cost.analyze(srv.step)
    DRY["served"] = dict(live=live, plan=eng.plan,
                         arrays=dryrun_gnn.to_meta(lay0),
                         d=int(params["layers"][0]["w"].shape[1]),
                         aggregations=len(params["layers"]),
                         seconds=round(time.perf_counter() - t_dry, 3))
    live.output = None

    # launches of one full forward pass
    K.reset_launch_counts()
    with torch.inference_mode():
        apply(params, eng, srv.xp)
    torch.cuda.synchronize()
    per_pass = K.launch_counts()   # K2 runs only with pb set

    # -- 4. the launcher ----------------------------------------------------
    rep_small = serve_gnn.main(["--scale", "1", "--requests", "30",
                                "--rotate", "--devices", "8"])
    check(rep_small["served"] > 0 and rep_small["device"].startswith("cuda"),
          "launcher did not serve on the card")
    say("launcher", served=rep_small["served"], p50_ms=rep_small["p50"] * 1e3)

    # -- 5. timings at the main path's shapes ------------------------------
    kernels = time_kernels(torch, eng, srv, params, ref, neighbor_agg, lay0,
                           rate)
    for k in kernels:
        k["launches_per_full_pass"] = per_pass[k["name"]]
    with torch.inference_mode():    # whole passes, as the serving steps run
        h1 = C.apply_stage("gcn", params, eng, srv.xp, 0)
        full_ms = _time(torch, lambda: apply(params, eng, srv.xp), reps=5)
        cached_ms = _time(torch, lambda: C.apply_from_stage(
            "gcn", params, eng, h1, 1), reps=5)
        breakdown = profile_pass(torch, lambda: apply(params, eng, srv.xp))
    say("passes", full_pass_ms=full_ms, cached_pass_ms=cached_ms,
        **breakdown)
    del srv, eng, lay0, offline, plain, h0, h_pb, h1

    # -- 6.-9. training ----------------------------------------------------
    k4 = train_full_graph(torch, C, K, g, ring, dev, ncls, rate, launches)
    kernels.append(k4)
    train_other_models(torch, C, K, dev, ncls)
    kernels.append(train_sampled(torch, C, K, g, dev, ncls, rate, launches))
    train_launcher(dev)
    k6, k4_fig9e = sparse_ring(torch, C, K, g, ring, dev, rate, launches)
    kernels.append(k6)
    # K4 at the fig9e plan's width too: bitwise on every group of both
    k4["fig9e"] = {k: v for k, v in k4_fig9e.items()
                   if k not in ("name", "route", "source", "replaces")}
    k4["bitwise_plain"] = k4["bitwise_plain"] and k4_fig9e["bitwise_plain"]
    part = tuner_on_card(torch, C, K, g, ring, dev, ncls, launches)
    # -- 14. tiered serving and the streamed ring ---------------------------
    k5_padded = tiered_streaming(torch, C, K, g, ring, dev, x, part, ncls,
                                 rate, launches)
    k5 = next(k for k in kernels if k["name"] == "gather_rows")
    k5["padded_table"] = {k: v for k, v in k5_padded.items()
                          if k not in ("name", "route", "source",
                                       "replaces")}
    k5["max_abs_err"] = max(k5["max_abs_err"], k5_padded["max_abs_err"])
    # -- 15. the serving cluster ---------------------------------------------
    cluster_phase(torch, C, K, g, x, params, part, dev, ncls, launches,
                  dict(p50_ms=float(np.percentile(lat, 50) * 1e3),
                       p99_ms=float(np.percentile(lat, 99) * 1e3)))
    # -- 16. the baselines ----------------------------------------------------
    baselines(torch, C, K, ops, ref, g, ring, dev, x, part, launches)
    del part
    SHARED.clear()

    # -- 11. dense-LM inference: the GNN phases' device state goes first ----
    del params, results, ring, apply, init
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(lm_inference(torch, K, dev, rate, flops, launches))

    # -- 12. xlstm inference: phase 11's device state goes first ------------
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated after phase 11")
    kernels.append(xlstm_inference(torch, K, dev, rate, flops, launches))

    # -- 17. LM training: phase 12's device state goes first ----------------
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated after phase 12")
    kernels.append(lm_training(torch, K, dev, rate, flops, launches))

    # -- 18. the moe and hybrid families: phase 17's device state goes first
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated after phase 17")
    k7 = next(k for k in kernels if k["name"] == "flash_attention")
    k7.update(moe_hybrid(torch, K, dev, rate, flops, launches))

    # -- 19. whisper-base: phase 18's device state goes first --------------
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated after phase 18")
    k7.update(whisper(torch, K, dev, rate, flops, launches))

    # -- 20. granite on a virtual (2, 4) mesh: phase 19's state goes first --
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated after phase 19")
    granite_mesh(torch, K, dev, launches)

    # -- 21. the dry-run counts held on the card ----------------------------
    dry_run_on_card(torch, K, flops, cells)

    for k in kernels:
        by_path = {p: launches[p][k["name"]] for p in launches
                   if k["name"] in PATH_KERNELS[p]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["launches_per_step"] = {p: by_path[p] / TRAIN_STEPS
                                  for p in ("training", "sampled", "sparse")
                                  if p in by_path}
        if "lm_training" in by_path:
            k["launches_per_step"]["lm_training"] = \
                by_path["lm_training"] / TRAIN_LM_STEPS
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def flash_tc_sass(_build):
    """Counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
    SASS of K7's bf16 kernel (every ``flash_tc_kernel`` instance of the
    built library, by cuobjdump), and the number of instances."""
    out = subprocess.run(
        [_build.toolkit_binary("cuobjdump"), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    fns = [f for f in out.stdout.split("Function : ")[1:]
           if "flash_tc_kernel" in f.split("\n", 1)[0]]
    check(fns, "no flash_tc_kernel in flash_attention's SASS")
    return {op: sum(f.count(op) for f in fns)
            for op in ("HGMMA", "UTMALDG")}, len(fns)


def _time(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _each_ms(torch, fn, n, warmup=3):
    """``n`` calls of ``fn``, each between its own CUDA events: their ms."""
    for _ in range(warmup):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def _device_ms(prof, reps=1):
    """Device ms a call by kernel name from a torch.profiler run over
    ``reps`` calls: device-side events only (kernels, copies), since a
    host op's "self" device time repeats the kernels it launched."""
    by_kernel = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[evt.key[:80]] = us / reps / 1e3
    return by_kernel


def profile_pass(torch, fn, reps=3):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    beside the host-clock time of the same calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    by_kernel = _device_ms(prof, reps)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_wall_ms=wall_ms, device_ms_sum=busy,
                device_ms_by_kernel=dict(top))


def time_by_group(torch, calls, groups):
    """Each group's launch timed alone (CUDA events) beside its work: its
    partitions, masked-in slots and distinct rows gathered."""
    rows = []
    for call, grp in zip(calls, groups):
        ms, n = _time(torch, call), grp.num_partitions
        rows.append(dict(partitions=n, masked_in_slots=int(grp.mask.sum()),
                         distinct_rows=int(grp.grad.rows.numel()), ms=ms,
                         ns_per_partition=ms * 1e6 / n))
    return rows


def segment_walks(grp):
    """A group's longest segment and the longest serial walk of K3's
    threads after chunking: the longest chunk (pass 1) plus the longest
    run of pass 2 (a short segment's partials or a hub's chunk sums)."""
    lens = np.diff(grp.seg_start.cpu().numpy())
    if lens.size == 0:
        return 0, 0
    ch = grp.chunks
    if ch is None:
        return int(lens.max()), int(lens.max())
    short = np.ones(lens.size, bool)
    short[ch.hubs.cpu().numpy()] = False
    pass1 = int((ch.chunk_end - ch.chunk_start).max())
    pass2 = max(int(lens[short].max(initial=0)),
                int(np.diff(ch.hub_chunks.cpu().numpy()).max()))
    return int(lens.max()), pass1 + pass2


def time_kernels(torch, eng, srv, params, ref, neighbor_agg, arrays, rate):
    """Time one aggregation's worth of each kernel (every group of the
    products plan: 7 remote ring steps + 7 interleaved local slices, D=16,
    the width both GCN layers aggregate at) with its real layer-0 input."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels.ops import SegmentChunks, chunk_length

    with torch.inference_mode():
        dinv = torch.rsqrt(eng.deg)[:, None]
        h = ((srv.xp @ params["layers"][0]["w"]) * dinv).contiguous()
        d = h.shape[1]
        n_dev, tile_rows = eng.plan.n_dev, eng.plan.tile_rows
        tiles = h.view(n_dev, tile_rows, d)
        cur = torch.roll(tiles, 1, 0).contiguous().view(-1, d)
        groups = [(cur, g) for g in arrays.remote_steps] + \
                 [(h, g) for g in arrays.local_steps]
        groups = [(b, g) for b, g in groups if g.num_partitions]
        out0 = torch.zeros_like(h)
        partials = [neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask)
                    for b, g in groups]
        w = [g.mask.float() for _, g in groups]
        nb_long = [g.nbrs.long() for _, g in groups]
        tgt = [g.seg_rows.long().repeat_interleave(
            (g.seg_start[1:] - g.seg_start[:-1]).long()) for _, g in groups]
        srt = [p.index_select(0, g.order.long())
               for p, (_, g) in zip(partials, groups)]

        valid = sum(int(g.mask.sum()) for _, g in groups)
        n_p = sum(g.num_partitions for _, g in groups)
        ps = groups[0][1].nbrs.shape[1]
        # each group's distinct gathered rows read once, every slot its id
        # and mask, every partition writes one row (kernels/cost.py, the
        # work each launch records)
        distinct = sum(int(g.grad.rows.numel()) for _, g in groups)
        gather_bytes = sum(cost.gather_sum(cost.host(g.nbrs),
                                           cost.host(g.mask), d).bytes
                           for _, g in groups)
        seg_bytes = sum(cost.segment_add(g.num_partitions,
                                         int(g.seg_rows.numel()), d).bytes
                        for _, g in groups)

        def k1():
            for b, g in groups:
                neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask)

        def k2(pb=4):
            for b, g in groups:
                neighbor_agg.gather_sum_blocked(b, g.nbrs, g.mask, pb=pb)

        def plain_gather():
            for b, g in groups:
                ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask)

        def lib_gather():
            for (b, g), nb, ww in zip(groups, nb_long, w):
                F.embedding_bag(nb, b, mode="sum", per_sample_weights=ww)

        outs = [out0.clone() for _ in groups]

        def k3(chunks=None):
            for o, p, (_, g), ch in zip(outs, partials, groups,
                                        chunks or [g.chunks
                                                   for _, g in groups]):
                neighbor_agg.segment_add_ordered(o, p, g.order, g.seg_rows,
                                                 g.seg_start, ch)

        def plain_seg():
            for o, p, (_, g) in zip(outs, partials, groups):
                ref.segment_add_ordered_ref(o, p, g.order, g.seg_rows,
                                            g.seg_start, g.chunks)

        def lib_seg():
            for o, s, t in zip(outs, srt, tgt):
                o.index_add_(0, t, s)

        # each kernel held to its plain version on every group, K1 bitwise
        err_k1, bitwise_k1 = 0.0, True
        for i, (b, g) in enumerate(groups):
            got = neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask)
            want = ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask)
            err_k1 = max(err_k1, held(got, want, "gather_sum_pipelined at "
                                                  "the main path's shapes"))
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            bitwise_k1 = bitwise_k1 and same
            check(same, f"gather_sum_pipelined, group {i} of the main path: "
                  "not bitwise its plain version")
        # K2 at pb = 4 bitwise its plain version and K1 on every group
        err_k2, bitwise_k2 = 0.0, True
        for i, (b, g) in enumerate(groups):
            got = neighbor_agg.gather_sum_blocked(b, g.nbrs, g.mask, pb=4)
            want = ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask)
            err_k2 = max(err_k2, held(got, want, "gather_sum_blocked at "
                                                  "the main path's shapes"))
            same = torch.equal(got.view(torch.int32),
                               want.view(torch.int32)) and torch.equal(
                got, neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask))
            bitwise_k2 = bitwise_k2 and same
            check(same, f"gather_sum_blocked, group {i} of the main path: "
                  "not bitwise its plain version and K1")
        # K3 bitwise its plain version on every group, hub chunks and all;
        # the error and the bitwise flag are read from these comparisons
        err_k3, bitwise_k3 = 0.0, True
        for i, (p, (_, g)) in enumerate(zip(partials, groups)):
            segs = (g.order, g.seg_rows, g.seg_start, g.chunks)
            got = neighbor_agg.segment_add_ordered(out0.clone(), p, *segs)
            want = ref.segment_add_ordered_ref(out0.clone(), p, *segs)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            err_k3 = max(err_k3, (got - want).abs().max().item())
            bitwise_k3 = bitwise_k3 and same
            check(same, f"segment_add_ordered, group {i} of the main path: "
                  "not bitwise its plain version")
        walks = [segment_walks(g) for _, g in groups]
        # the chunk length on the card: K3's time with each group's hubs
        # cut at other lengths (the index is a function of seg_start) than
        # the one the rule keeps for this plan's longest segment
        kept = chunk_length(max(w[0] for w in walks))
        alt = {c: [SegmentChunks.build(g.seg_start.cpu().numpy(), h.device,
                                       chunk=c) for _, g in groups]
               for c in (32, 64, 128, 256) if c != kept}

        # plain and library calls around the kernels: plain, kernel,
        # kernel, plain in one process on one card
        t_plain_g = _time(torch, plain_gather, reps=5)
        t_k1 = _time(torch, k1)
        t_k2 = _time(torch, k2)
        t_k2_by_pb = {pb: _time(torch, lambda pb=pb: k2(pb))
                      for pb in (1, 2, 8)}
        t_k2_by_pb[4] = t_k2
        t_lib_g = _time(torch, lib_gather)
        t_lib_s = _time(torch, lib_seg)
        # the kept chunk length timed before and after the others, which
        # run between: its time is the mean of its two readings
        t_k3_runs = [_time(torch, k3)]
        t_k3_by_chunk = {c: _time(torch, lambda ch=ch: k3(ch))
                         for c, ch in alt.items()}
        t_k3_runs.append(_time(torch, k3))
        t_k3 = t_k3_by_chunk[kept] = sum(t_k3_runs) / 2
        t_plain_s = _time(torch, plain_seg, reps=2, warmup=1)
        k1_groups = time_by_group(torch, [
            lambda b=b, g=g: neighbor_agg.gather_sum_pipelined(b, g.nbrs,
                                                               g.mask)
            for b, g in groups], [g for _, g in groups])

    def row(name, ms, plain_ms, lib_ms, lib, nbytes, err):
        return dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=nbytes / rate * 1e3,
                    bound_by="bytes", library_ms=lib_ms, library=lib,
                    bytes=nbytes, groups=len(groups), partitions=n_p,
                    valid_slots=valid, distinct_rows=distinct, width=d)

    return [dict(row("gather_sum_pipelined", t_k1, t_plain_g, t_lib_g,
                     "embedding_bag", gather_bytes, err_k1),
                 bitwise_plain=bitwise_k1, by_group=k1_groups,
                 bytes_split=dict(rows=distinct * d * 4,
                                  index=n_p * ps * (4 + 1),
                                  output=n_p * d * 4)),
            dict(row("gather_sum_blocked", t_k2, t_plain_g, t_lib_g,
                     "embedding_bag", gather_bytes, err_k2),
                 pb=4, bitwise_plain=bitwise_k2,
                 ms_by_pb=dict(sorted(t_k2_by_pb.items()))),
            dict(row("segment_add_ordered", t_k3, t_plain_s, t_lib_s,
                     "index_add_", seg_bytes, err_k3),
                 bitwise_plain=bitwise_k3, chunk_len=kept, ms_runs=t_k3_runs,
                 ms_by_chunk_len=dict(sorted(t_k3_by_chunk.items())),
                 hub_chunks=sum(g.chunks.num_chunks for _, g in groups
                                if g.chunks is not None),
                 longest_segment_by_group=[w[0] for w in walks],
                 longest_walk_by_group=[w[1] for w in walks])]


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def _grads_held(torch, got, want, rtol, what):
    """Every leaf of two gradient trees within ``rtol``, with ``atol =
    rtol · max|want|`` per leaf (a leaf's sums over millions of nodes
    leave entries near zero beside entries of its full scale), and none
    all zero; returns the largest absolute difference."""
    from repro_torch.train.tree import tree_flatten_with_names

    worst = 0.0
    for (name, a), (_, b) in zip(tree_flatten_with_names(got),
                                 tree_flatten_with_names(want)):
        scale = b.abs().max().item()
        check(scale > 0, f"{what}: gradient of {name} is 0")
        check(a.shape == b.shape
              and torch.allclose(a, b, rtol=rtol, atol=rtol * scale),
              f"{what}: gradient of {name} disagrees")
        worst = max(worst, (a - b).abs().max().item())
    return worst


def _bitwise(torch, a_tree, b_tree):
    from repro_torch.train.tree import tree_leaves

    return all(torch.equal(a, b)
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _fused(eng):
    return dataclasses.replace(eng, layer_plans=[
        dataclasses.replace(lp, fuse_update=True) for lp in eng.layer_plans])


def _with_topk(eng, k):
    """The engine with its hidden layers on the top-k ring (same plan)."""
    return dataclasses.replace(eng, layer_plans=[
        dataclasses.replace(lp, topk=k) for lp in eng.layer_plans])


def _tables(torch, C, eng, x, y, train_mask, dev):
    pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                 a[:, None])[:, 0]
    return (eng.shard(eng.pad(x)), torch.from_numpy(pad1(y)).to(dev),
            torch.from_numpy(pad1(train_mask.astype(np.float32))).to(dev))


def shared_engine(C, g, ring):
    """The GCN engine at (``STREAM_PS``, ``STREAM_DIST``) on ``g`` and
    ``ring``: built by phase 6, the same object for phases 13 (b), 14 and
    16 (their plans were built alike, the partition a function of ``g``
    and the shard count)."""
    if "engine" not in SHARED:
        SHARED["engine"] = C.GNNEngine.build(g, ring, ps=STREAM_PS,
                                             dist=STREAM_DIST)
    return SHARED["engine"]


def train_full_graph(torch, C, K, g, ring, dev, ncls, rate, launches):
    """Phase 6: GCN training on the full products stand-in."""
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    eng = shared_engine(C, g, ring)
    xp, yp, mp = _tables(torch, C, eng, x, y, train_mask, dev)
    del x
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        hidden=16, num_layers=2, device=dev)
    arrays = eng.ring_arrays[0]
    groups = arrays.remote_steps + arrays.local_steps
    say("train_built", nodes=g.num_nodes, padded_rows=eng.plan.padded_nodes,
        d_in=d_in, classes=ncls, hidden=16, layers=2, shards=ring.n_dev,
        config=eng.config, groups=len(groups),
        partitions=sum(grp.num_partitions for grp in groups),
        masked_slots=sum(grp.grad.num_slots for grp in groups),
        build_s=round(time.perf_counter() - t0, 3))

    def loss_fn(e):
        return lambda p: C.masked_cross_entropy(C.gcn_apply(p, e, xp), yp, mp)

    # held outside the main path's window: the same step twice, the plain
    # path at full size, and the fused dataflow
    loss_a, g_a = value_and_grad(loss_fn(eng), params)
    loss_b, g_b = value_and_grad(loss_fn(eng), params)
    check(torch.equal(loss_a, loss_b) and _bitwise(torch, g_a, g_b),
          "two runs of step 0 differ")
    t0 = time.perf_counter()
    loss_p, g_p = value_and_grad(
        loss_fn(dataclasses.replace(eng, use_kernel=False)), params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err_plain = _grads_held(torch, g_a, g_p, 1e-4, "kernels vs plain path")
    loss_f, g_f = value_and_grad(loss_fn(_fused(eng)), params)
    err_fused = _grads_held(torch, g_f, g_a, 2e-4, "fused vs unfused")
    check(torch.allclose(loss_f, loss_a, rtol=2e-4), "fused loss differs")
    say("train_step0_checked", loss=float(loss_a),
        bitwise_twice=True, plain_loss=float(loss_p),
        plain_max_abs_err=err_plain, tolerance_plain=TOL_PLAIN,
        plain_step_s=round(plain_s, 3), fused_loss=float(loss_f),
        fused_max_abs_err=err_fused, tolerance_fused=TOL_FUSED)

    # the main path: TRAIN_STEPS AdamW steps on the kernels
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    p, losses, wall = params, [], []
    K.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_fn(eng), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            check(_bitwise(torch, grads, g_a), "step 0 != its held run")
    launches["training"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["training"]),
          f"a kernel of the training path never launched: {counts}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    say("train_steps", steps=TRAIN_STEPS, losses=losses,
        step_wall_ms=wall, launches=counts,
        launches_per_step={k: v / TRAIN_STEPS for k, v in counts.items()})

    def one_step():
        loss, grads = value_and_grad(loss_fn(eng), p)
        adamw_update(grads, opt, p, ocfg)

    # the step is host-bound: after a single warm-up, five reps can read
    # far above its steady state
    step_ms = _time(torch, one_step, reps=10, warmup=3)
    breakdown = profile_pass(torch, one_step, reps=2)
    say("train_step_time", step_ms=step_ms, **breakdown)
    return time_scatter(torch, K, arrays, eng.plan, rate, dev, 16)


def train_other_models(torch, C, K, dev, ncls):
    """Phase 7: one step of GIN, SAGE and GAT on a reduced stand-in."""
    from repro_torch.dist import VirtualRing
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    g, _ = C.paper_dataset("products", scale=REDUCED_SCALE, seed=0)
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    eng = C.GNNEngine.build(g, VirtualRing(8, dev), ps=16, dist=2)
    xp, yp, mp = _tables(torch, C, eng, x, y, train_mask, dev)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    for model in ("gin", "sage", "gat"):
        init, apply, kw = C.MODEL_ZOO[model]
        params = init(torch.Generator().manual_seed(0), d_in, ncls,
                      device=dev, **kw)

        def grads(e):
            return value_and_grad(lambda p: C.masked_cross_entropy(
                apply(p, e, xp), yp, mp), params)

        loss, g_k = grads(eng)
        _, g_p = grads(dataclasses.replace(eng, use_kernel=False))
        err = _grads_held(torch, g_k, g_p, 1e-4, f"{model}: kernels vs plain")
        _, g_f = grads(_fused(eng))
        if model == "gat":       # W runs before aggregation: nothing to fuse
            check(_bitwise(torch, g_f, g_k), "gat: fused != unfused")
            err_f = 0.0
        else:
            err_f = _grads_held(torch, g_f, g_k, 2e-4,
                                f"{model}: fused vs unfused")
        p2, _, m = adamw_update(g_k, adamw_init(params), params, ocfg)
        check(np.isfinite(float(loss)) and np.isfinite(float(m["grad_norm"])),
              f"{model}: loss or gradient not finite")
        topk = {}
        if model != "gat":       # GAT stays on the dense ring under topk
            k = kw["hidden"] // 4
            eng_k = _with_topk(eng, k)
            before = K.launch_counts()["sparse_gather_sum"]
            loss_k, g_kk = grads(eng_k)
            check(K.launch_counts()["sparse_gather_sum"] > before,
                  f"{model}: the top-k step launched no sparse gather-sum")
            _, g_kp = grads(dataclasses.replace(eng_k, use_kernel=False))
            topk = dict(topk=k, topk_loss=float(loss_k),
                        topk_plain_max_abs_err=_grads_held(
                            torch, g_kk, g_kp, 1e-4,
                            f"{model} topk={k}: kernels vs plain"))
        say("train_model", model=model, nodes=g.num_nodes, **kw,
            loss=float(loss), grad_norm=float(m["grad_norm"]),
            plain_max_abs_err=err, fused_max_abs_err=err_f,
            tolerance_plain=TOL_PLAIN, tolerance_fused=TOL_FUSED, **topk)


def train_sampled(torch, C, K, g, dev, ncls, rate, launches):
    """Phase 8: sampled GraphSAGE over the tiered store at full size."""
    from repro_torch.sample import block_tree, sample_blocks, seed_batches
    from repro_torch.store import FeatureStore, TieredFeatures
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    n, d_in, fanout, batch = g.num_nodes, 100, 10, 1024
    x, y, train_mask = graph_features(n, d_in, ncls, seed=0)
    store = FeatureStore(x, copy=False, pin=True)
    hot_order = np.argsort(-np.diff(g.indptr))
    tiers = TieredFeatures(store, None, n // 8, device=dev)
    tiers.admit(hot_order[: n // 8])
    params = C.sage_init(torch.Generator().manual_seed(0), d_in, ncls,
                         hidden=32, num_layers=2, device=dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    rng = np.random.default_rng(0)
    batches = seed_batches(np.nonzero(train_mask)[0], batch, rng=rng)
    say("sampled_built", nodes=n, d_in=d_in, fanout=fanout, batch=batch,
        capacity=tiers.capacity, pinned=True,
        build_s=round(time.perf_counter() - t0, 3))

    def batch_of(seeds, valid):
        blocks = sample_blocks(g, seeds, [fanout, fanout], batch=batch,
                               rng=rng)
        return (blocks, tiers.gather_rows(blocks[0].src_ids),
                block_tree(blocks, dev),
                torch.from_numpy(y[np.clip(seeds, 0, None)]).to(dev),
                torch.from_numpy(valid).to(dev))

    def loss_of(b, use_kernel=True):
        _, h0, bt, yb, mb = b
        return lambda p: C.masked_cross_entropy(
            C.apply_blocks("sage", p, h0, bt, use_kernel=use_kernel), yb, mb)

    # held outside the window: one batch's gradients against the plain path
    b = batch_of(*next(batches))
    _, g_k = value_and_grad(loss_of(b), params)
    _, g_p = value_and_grad(loss_of(b, use_kernel=False), params)
    err = _grads_held(torch, g_k, g_p, 1e-4, "sampled: kernels vs plain")

    p, losses, wall = params, [], []
    K.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        seeds, valid = next(batches)
        t0 = time.perf_counter()
        b = batch_of(seeds, valid)
        loss, grads = value_and_grad(loss_of(b), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches["sampled"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["sampled"]),
          f"a kernel of the sampled path never launched: {counts}")
    check(all(np.isfinite(losses)), f"sampled loss not finite: {losses}")
    say("sampled_steps", steps=TRAIN_STEPS, losses=losses,
        step_wall_ms=wall, launches=counts, store=tiers.report(),
        plain_max_abs_err=err, tolerance_plain=TOL_PLAIN,
        src_rows=int(b[0][0].num_src))

    # the tiered rows, bitwise x[ids], at capacities 0, N // 8 and N
    ids = b[0][0].src_ids
    x_dev = torch.from_numpy(store.x).to(dev)
    live = torch.from_numpy(ids).to(dev)
    want = torch.where((live >= 0)[:, None], x_dev[live.clamp_min(0)], 0.0)
    del x_dev
    hits = {}
    for cap in (0, n // 8, n):
        t = TieredFeatures(store, None, cap, device=dev)
        if cap:
            t.admit(hot_order[:cap])
        got = t.gather_rows(ids)
        check(torch.equal(got, want), f"gather_rows != x[ids] at cap {cap}")
        hits[cap] = t.report()["hit_rate"]
        del t, got
    say("tiered_rows_checked", bitwise=True, rows=int(ids.size),
        hit_rate_by_capacity=hits)
    return time_gather_rows(torch, K, tiers, ids, rate, dev)


def train_launcher(dev):
    """Phase 9: the training launcher, both branches, at a small scale."""
    from repro_torch.launch import train_gnn

    work = os.path.join(ROOT, "build", "train_gnn_smoke")
    full = train_gnn.main(["--scale", "1", "--steps", "3", "--devices", "8",
                           "--workdir", work])
    sampled = train_gnn.main(["--scale", "1", "--steps", "3", "--model",
                              "sage", "--sample-fanout", "5",
                              "--sample-batch", "256"])
    for rep in (full, sampled):
        check(rep["device"].startswith("cuda")
              and np.isfinite(rep["losses"]).all(),
              "training launcher did not train on the card")
    say("train_launcher", full_losses=full["losses"],
        full_test_acc=full["test_acc"], sampled_losses=sampled["losses"],
        sampled_test_acc=sampled["test_acc"],
        sampled_hit_rate=sampled["store"]["hit_rate"])


def sparse_ring(torch, C, K, g, ring, dev, rate, launches):
    """Phase 10: the top-k compressed ring at full size (fig9e)."""
    from repro_torch.serve import (GNNServeEngine, TrafficPhase,
                                   WorkloadStats, ZipfTraffic, run_trace)
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    d, ncls, k = SPARSE_D, SPARSE_CLASSES, SPARSE_KS[-1]
    x, y, train_mask = graph_features(g.num_nodes, d, ncls, seed=1)
    dense = C.GNNEngine.build(g, ring, ps=8, dist=2)
    engines = {kk: _with_topk(dense, kk) for kk in SPARSE_KS}
    eng, plan = engines[k], dense.plan
    xp, yp, mp = _tables(torch, C, dense, x, y, train_mask, dev)
    params = C.gcn_init(torch.Generator().manual_seed(0), d, ncls, hidden=d,
                        num_layers=3, device=dev)
    arrays = dense.ring_arrays[0]
    groups = arrays.remote_steps + arrays.local_steps
    dense_wire = C.collective_bytes(plan, d)
    say("sparse_built", nodes=g.num_nodes, padded_rows=plan.padded_nodes,
        d_in=d, classes=ncls, hidden=d, layers=3, shards=ring.n_dev,
        config=dense.config, topk=list(SPARSE_KS), groups=len(groups),
        partitions=sum(grp.num_partitions for grp in groups),
        masked_slots=sum(grp.grad.num_slots for grp in groups),
        dense_wire_bytes=dense_wire,
        wire_ratio={kk: C.sparse_collective_bytes(plan, d, kk) / dense_wire
                    for kk in SPARSE_KS},
        build_s=round(time.perf_counter() - t0, 3))

    with torch.inference_mode():    # k == D: the dense ring's bits
        check(torch.equal(C.gcn_apply(params, engines[d], xp),
                          C.gcn_apply(params, dense, xp)),
              f"top-k at k = D = {d}: logits differ from the dense ring")

    def loss_fn(e):
        return lambda p: C.masked_cross_entropy(C.gcn_apply(p, e, xp), yp, mp)

    # held outside the main path's window: the same step twice and the
    # plain path at full size
    loss_a, g_a = value_and_grad(loss_fn(eng), params)
    loss_b, g_b = value_and_grad(loss_fn(eng), params)
    check(torch.equal(loss_a, loss_b) and _bitwise(torch, g_a, g_b),
          "top-k: two runs of step 0 differ")
    t0 = time.perf_counter()
    loss_p, g_p = value_and_grad(
        loss_fn(dataclasses.replace(eng, use_kernel=False)), params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err_plain = _grads_held(torch, g_a, g_p, 1e-4,
                            "top-k: kernels vs plain path")
    say("sparse_step0_checked", topk=k, loss=float(loss_a),
        bitwise_twice=True, plain_loss=float(loss_p),
        plain_max_abs_err=err_plain, tolerance_plain=TOL_PLAIN,
        plain_step_s=round(plain_s, 3), k_equals_d_bitwise_dense=True)

    # the reference's fig9e optimiser: AdamW, lr 2e-2, 2 warmup steps
    ocfg = AdamWConfig(lr=2e-2, warmup_steps=2, total_steps=2 * TRAIN_STEPS,
                       weight_decay=0.0)

    def train(e, window):
        p, opt, losses, wall = params, adamw_init(params), [], []
        if window:
            K.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, grads = value_and_grad(loss_fn(e), p)
            p, opt, _ = adamw_update(grads, opt, p, ocfg)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if i == 0 and window:
                check(_bitwise(torch, grads, g_a), "top-k: step 0 != its "
                      "held run")
        return p, opt, losses, wall

    p_k, opt_k, losses_k, wall_k = train(eng, True)
    launches["sparse"] = counts = K.launch_counts()
    check(all(counts[n] > 0 for n in PATH_KERNELS["sparse"]),
          f"a kernel of the top-k training path never launched: {counts}")
    _, _, losses_d, wall_d = train(dense, False)
    check(all(np.isfinite(losses_k + losses_d)),
          f"top-k or dense loss not finite: {losses_k} {losses_d}")

    def one_step(e):
        def run():
            loss, grads = value_and_grad(loss_fn(e), p_k)
            adamw_update(grads, opt_k, p_k, ocfg)
        return run

    step_ms = {str(k): _time(torch, one_step(eng), reps=5, warmup=1),
               "dense": _time(torch, one_step(dense), reps=5, warmup=1)}
    breakdown = profile_pass(torch, one_step(eng), reps=2)
    dense_breakdown = profile_pass(torch, one_step(dense), reps=2)
    with torch.inference_mode():    # the two serving passes, each engine
        passes_ms = {}
        for name, e in ((str(k), eng), ("dense", dense)):
            h1 = C.apply_stage("gcn", p_k, e, xp, 0)
            passes_ms[name] = dict(
                full=_time(torch, lambda: C.gcn_apply(p_k, e, xp), reps=5),
                cached=_time(torch, lambda: C.apply_from_stage(
                    "gcn", p_k, e, h1, 1), reps=5))
        del h1
    say("sparse_steps", steps=TRAIN_STEPS, topk=k, losses=losses_k,
        dense_losses=losses_d, step_wall_ms=wall_k, dense_step_wall_ms=wall_d,
        launches=counts,
        launches_per_step={n: v / TRAIN_STEPS for n, v in counts.items()},
        step_ms=step_ms, pass_ms=passes_ms, **breakdown,
        dense_profiled_wall_ms=dense_breakdown["profiled_wall_ms"],
        dense_device_ms_sum=dense_breakdown["device_ms_sum"],
        dense_device_ms_by_kernel=dense_breakdown["device_ms_by_kernel"])

    # serving at k on the trained weights: a Zipf trace, then served ==
    # offline through a full and a cached pass, each run's launches read
    srv = GNNServeEngine(eng, p_k, "gcn", x, g, slots=8,
                         stats=WorkloadStats(window=32))
    phases = [TrafficPhase(requests=100, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.02),
              TrafficPhase(requests=100, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.02)]
    events = list(ZipfTraffic(g.num_nodes, d, phases, seed=1))
    n_requests = sum(not ev.is_update for ev in events)
    K.reset_launch_counts()
    results = run_trace(srv, events)
    torch.cuda.synchronize()
    launches["sparse_serving"] = counts = K.launch_counts()
    check(all(counts[n] > 0 for n in PATH_KERNELS["sparse_serving"]),
          f"a kernel of the top-k serving path never launched: {counts}")
    check(len(results) == n_requests and all(
        np.isfinite(r.logits).all() and r.logits.shape == (r.seeds.size, ncls)
        for r in results), "top-k serving: bad or missing responses")
    lat = np.array([r.latency for r in results])
    seeds = np.unique(np.concatenate([r.seeds for r in results[:3]]))[:8]
    srv.cache.invalidate()
    per_pass = {}
    for kind in ("full", "cached"):
        srv.submit(seeds)
        K.reset_launch_counts()
        (res,) = srv.step()
        per_pass[kind] = K.launch_counts()
        check(res.cached == (kind == "cached"), f"no {kind} pass taken")
        check(per_pass[kind]["sparse_gather_sum"] > 0,
              f"the {kind} served pass launched no sparse gather-sum")
        with torch.inference_mode():
            offline = C.gcn_apply(p_k, eng, srv.xp)
        rows = torch.from_numpy(C.pgas_rows(plan, seeds).astype(np.int64))
        check(np.array_equal(res.logits, offline[rows.to(dev)].cpu().numpy()),
              f"top-k: the {kind} served pass != offline")
    say("sparse_served", topk=k, requests=len(results),
        p50_ms=float(np.percentile(lat, 50) * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
        cache_hit_rate=srv.report()["cache_hit_rate"], launches=counts,
        launches_per_served_pass=per_pass,
        served_equals_offline="bitwise (full, cached)")

    # K6 at layer 1's aggregation, the wire's rotations, torch.topk
    with torch.inference_mode():
        h1 = C.apply_stage("gcn", p_k, eng, srv.xp, 0)
        z = ((h1 @ p_k["layers"][1]["w"])
             * torch.rsqrt(eng.deg)[:, None]).contiguous()
        del srv, h1, offline
        k6 = time_sparse_gather_sum(torch, C, K, z, k, arrays, plan, rate)
        k6["launches_per_served_pass"] = {
            kind: c["sparse_gather_sum"] for kind, c in per_pass.items()}
        topk_ms = _time(torch, lambda: torch.topk(z, k, dim=1))
        rot_ms = {str(kk): time_rotations(torch, ring, plan, d, kk, dev)
                  for kk in SPARSE_KS}
        rot_ms["dense"] = time_rotations(torch, ring, plan, d, None, dev)
    k4 = time_scatter(torch, K, arrays, plan, rate, dev, d)
    say("sparse_wire", topk_ms=topk_ms, topk_shape=list(z.shape),
        rotation_ms_per_aggregation=rot_ms,
        rotations_per_aggregation=plan.dist * (plan.n_dev - 1),
        wire_bytes={str(kk): C.sparse_collective_bytes(plan, d, kk)
                    for kk in SPARSE_KS}, dense_wire_bytes=dense_wire)
    return k6, k4


def time_rotations(torch, ring, plan, d, k, dev):
    """The rotation copies of one aggregation alone: ``dist`` chunks of
    ``n_dev - 1`` rotations each, of the dense tiles (``k=None``) or of
    the ``(values, int16 ids)`` pair."""
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    shape = (n_dev, dist, tile_rows)
    if k is None:
        src = torch.zeros((*shape, d), device=dev)
        pick = lambda c: src[:, c]
        bufs = [torch.empty((n_dev, tile_rows, d), device=dev)
                for _ in range(2)]
    else:
        vals = torch.zeros((*shape, k), device=dev)
        ids = torch.zeros((*shape, k), dtype=torch.int16, device=dev)
        pick = lambda c: (vals[:, c], ids[:, c])
        bufs = [(torch.empty((n_dev, tile_rows, k), device=dev),
                 torch.empty((n_dev, tile_rows, k), dtype=torch.int16,
                             device=dev)) for _ in range(2)]

    def run():
        for c in range(dist):
            cur, nxt = bufs
            ring.wait(ring.rotate(pick(c), cur))
            for _ in range(n_dev - 2):
                ring.wait(ring.rotate(cur, nxt))
                cur, nxt = nxt, cur

    return _time(torch, run)


def time_sparse_gather_sum(torch, C, K, z, k, arrays, plan, rate):
    """Time one aggregation's worth of K6 at layer 1 of the fig9e model:
    every group of the plan on its compressed input (each remote step on
    its chunk's tile rotated as the ring rotates it), held bitwise to the
    plain version group by group; K1 on the dense input of the same
    groups (the dense ring's gather-sum at D = 96) held and timed too."""
    import torch.nn.functional as F

    ref = K.ref
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    d = z.shape[1]
    vals, idx = C.topk_activation(z, k)
    idx = idx.to(C.wire_index_dtype(d))
    vt, it, zt = (t.view(n_dev, dist, tile_rows, -1) for t in (vals, idx, z))
    groups = [(vals, idx, grp) for grp in arrays.local_steps]
    dense = [z for _ in arrays.local_steps]
    for s, grp in enumerate(arrays.remote_steps):
        kk, c = divmod(s, dist)
        v, i, zz = (torch.roll(t[:, c], kk + 1, 0).reshape(-1, t.shape[-1])
                    for t in (vt, it, zt))
        groups.append((v, i, grp))
        dense.append(zz)
    if arrays.local is not None:
        groups.append((vals, idx, arrays.local))
        dense.append(z)
    keep = [j for j, gr in enumerate(groups) if gr[2].num_partitions]
    groups, dense = [groups[j] for j in keep], [dense[j] for j in keep]
    err, bitwise = 0.0, {"k6": True, "k1": True}
    for j, (v, i, grp) in enumerate(groups):
        got = K.neighbor_agg.sparse_gather_sum(v, i, grp.nbrs, grp.mask, d)
        want = ref.sparse_gather_sum_ref(v, i, grp.nbrs, grp.mask, d)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        bitwise["k6"] = bitwise["k6"] and same
        check(same, f"sparse_gather_sum, fig9e group {j}: not bitwise its "
              "plain version")
        err = max(err, (got - want).abs().max().item())
        got = K.neighbor_agg.gather_sum_pipelined(dense[j], grp.nbrs,
                                                  grp.mask)
        want = ref.neighbor_gather_sum_ref(dense[j], grp.nbrs, grp.mask)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        bitwise["k1"] = bitwise["k1"] and same
        check(same, f"gather_sum_pipelined at D = {d}, fig9e group {j}: "
              "not bitwise its plain version")
    del got, want
    nb_long = [grp.nbrs.long() for _, _, grp in groups]
    weights = [grp.mask.float() for _, _, grp in groups]

    def k6():
        for v, i, grp in groups:
            K.neighbor_agg.sparse_gather_sum(v, i, grp.nbrs, grp.mask, d)

    def plain():
        for v, i, grp in groups:
            ref.sparse_gather_sum_ref(v, i, grp.nbrs, grp.mask, d)

    def composite():      # two calls: decompress, then embedding_bag
        for (v, i, _), nb, w in zip(groups, nb_long, weights):
            F.embedding_bag(nb, C.topk_decompress(v, i, d), mode="sum",
                            per_sample_weights=w)

    def k1():
        for zz, (_, _, grp) in zip(dense, groups):
            K.neighbor_agg.gather_sum_pipelined(zz, grp.nbrs, grp.mask)

    t_plain = _time(torch, plain, reps=2, warmup=1)
    t_k6 = _time(torch, k6)
    t_comp = _time(torch, composite)
    t_k1 = _time(torch, k1)
    k6_groups = time_by_group(torch, [
        lambda v=v, i=i, grp=grp: K.neighbor_agg.sparse_gather_sum(
            v, i, grp.nbrs, grp.mask, d) for v, i, grp in groups],
        [grp for _, _, grp in groups])
    valid = sum(int(grp.mask.sum()) for _, _, grp in groups)
    n_p = sum(grp.num_partitions for _, _, grp in groups)
    ps = groups[0][2].nbrs.shape[1]
    id_bytes = idx.element_size()
    # each group's distinct gathered rows (its GradIndex segments) read
    # once, k values and k ids each; every slot its id and mask; every
    # partition writes one D-wide row (kernels/cost.py)
    distinct = sum(int(grp.grad.rows.numel()) for _, _, grp in groups)
    nbytes = sum(K.cost.sparse_gather_sum(
        K.cost.host(grp.nbrs), K.cost.host(grp.mask), k, d, id_bytes).bytes
        for _, _, grp in groups)
    return dict(name="sparse_gather_sum", route="cuda",
                source=SOURCE["sparse_gather_sum"],
                replaces=REPLACES["sparse_gather_sum"], max_abs_err=err,
                ms=t_k6, plain_ms=t_plain, bound_ms=nbytes / rate * 1e3,
                bound_by="bytes", library_ms=None, library="none",
                composite_ms=t_comp,
                composite="topk_decompress + embedding_bag (two calls)",
                bytes=nbytes, groups=len(groups), partitions=n_p,
                valid_slots=valid, distinct_rows=distinct, width=d, k=k,
                id_dtype=str(idx.dtype), bitwise_plain=bitwise["k6"],
                by_group=k6_groups,
                bytes_split=dict(rows=distinct * k * (4 + id_bytes),
                                 index=n_p * ps * (4 + 1),
                                 output=n_p * d * 4),
                dense_gather_sum_ms=t_k1,
                dense_gather_sum_bitwise=bitwise["k1"],
                dense_gather_sum="K1 on the dense (P, 96) input, same groups")


def time_scatter(torch, K, arrays, plan, rate, dev, d):
    """Time one backward aggregation's worth of K4 (every group of a
    training plan at width ``d``), held bitwise to its plain version group
    by group, and timed again with the hubs cut at other chunk lengths."""
    ref, ops = K.ref, K.ops
    rows = plan.padded_nodes
    tile_total = plan.n_dev * plan.tile_rows
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((rows, d), generator=gen, device=dev)
    groups = [(tile_total, grp) for grp in arrays.remote_steps] + \
             [(rows, grp) for grp in arrays.local_steps] + \
             ([(rows, arrays.local)] if arrays.local is not None else [])
    groups = [(n, grp.grad) for n, grp in groups if grp.grad.num_slots]
    err, bitwise = 0.0, True
    for i, (n, ix) in enumerate(groups):
        base = torch.randn((n, d), generator=gen, device=dev)
        got = K.neighbor_agg.scatter_sum_ordered(base.clone(), g, ix)
        want = ref.scatter_sum_ordered_ref(base.clone(), g, ix)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = max(err, (got - want).abs().max().item())
        bitwise = bitwise and same
        check(same, f"scatter_sum_ordered at D = {d}, group {i}: not "
              "bitwise its plain version")
    del base, got, want
    outs = [torch.zeros((n, d), device=dev) for n, _ in groups]
    slot_rows = [ix.rows.long().repeat_interleave(
        (ix.start[1:] - ix.start[:-1]).long()) for _, ix in groups]
    g_slots = [g.index_select(0, ix.src.long()) for _, ix in groups]
    # the same index with its hubs cut at other chunk lengths
    alt = {c: [dataclasses.replace(ix, chunks=ops.SegmentChunks.build(
        ix.start.cpu().numpy(), dev, chunk=c)) for _, ix in groups]
        for c in (64, 128, 256, 512, 1024)}

    def k4(index=None):
        for o, ix in zip(outs, index or [ix for _, ix in groups]):
            K.neighbor_agg.scatter_sum_ordered(o, g, ix)

    def plain():
        for o, (_, ix) in zip(outs, groups):
            ref.scatter_sum_ordered_ref(o, g, ix)

    def lib():
        for o, r, gs in zip(outs, slot_rows, g_slots):
            o.index_add_(0, r, gs)

    with torch.inference_mode():
        t_plain = _time(torch, plain, reps=2, warmup=1)
        t_k4 = _time(torch, k4)
        t_lib = _time(torch, lib)
        by_chunk = {c: _time(torch, lambda ix=ix: k4(ix))
                    for c, ix in alt.items()}
    del g_slots, slot_rows, outs
    chunks = [ix.chunks for _, ix in groups]
    lens = [ix.start[1:] - ix.start[:-1] for _, ix in groups]
    longest = [int(x.max()) for x in lens]
    slots = sum(ix.num_slots for _, ix in groups)
    segs = sum(int(ix.rows.numel()) for _, ix in groups)
    # g's rows read once each, ids and offsets, dbuf's rows read and written
    # (kernels/cost.py)
    nbytes = sum(K.cost.scatter_sum(K.cost.host(ix.src), int(ix.rows.numel()),
                                    d).bytes for _, ix in groups)
    return dict(name="scatter_sum_ordered", route="cuda",
                source=SOURCE["scatter_sum_ordered"],
                replaces=REPLACES["scatter_sum_ordered"], max_abs_err=err,
                ms=t_k4, plain_ms=t_plain, bound_ms=nbytes / rate * 1e3,
                bound_by="bytes", library_ms=t_lib, library="index_add_",
                bytes=nbytes, groups=len(groups), masked_slots=slots,
                segments=segs, longest_segment=max(longest), width=d,
                bitwise_plain=bitwise,
                chunk_len=ops.chunk_length(max(longest)),
                chunk_len_by_group=[0 if ch is None else ch.chunk
                                    for ch in chunks],
                hubs=sum(int(ch.hubs.numel()) for ch in chunks if ch),
                hub_chunks=sum(ch.num_chunks for ch in chunks if ch),
                ms_by_chunk_len=dict(sorted(by_chunk.items())))


def sweep_gather_rows(torch, K, ref, dev, gen):
    """K5 bitwise its plain version (and across two launches) over its
    plan's edge shapes: one row, a chunk of UNROLL x THREADS vectors less
    one, exactly and plus one, more than 4 turns of the grid-stride loop,
    at every width of K5_SWEEP_D; ids repeated, -1, T and 2^31 - 1 among
    them, or all equal; and src 4 bytes off 16 (the word path).
    Returns the cases run."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    for d in K5_SWEEP_D:
        for offset in (False, True) if d % 4 == 0 else (False,):
            width = 4 if d % 4 == 0 and not offset else 1
            vpr = d // width
            chunk = K.rows.UNROLL * K.rows.THREADS
            grid = sms * K.rows.blocks_per_sm(dev.index, width)
            a_chunk = -(-chunk // vpr)
            for b in (1, a_chunk - 1, a_chunk, a_chunk + 1,
                      5 * grid * chunk // vpr + 3):
                for equal in (False, True):
                    t = 500
                    src = torch.from_numpy(gen.normal(size=(t, d)).astype(
                        np.float32)).to(dev)
                    ids = gen.integers(0, t, b)
                    if equal:
                        ids[:] = t // 2
                    else:
                        ids[3::13] = ids[0]             # repeated rows
                        ids[::5] = -1                   # zero rows
                        ids[1::7] = t
                        ids[2::11] = 2 ** 31 - 1
                    idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
                    if offset:
                        flat = torch.empty(t * d + 1, device=dev)
                        src = flat[1:].view(t, d).copy_(src)
                    want = ref.gather_rows_ref(src, idx)
                    got = K.rows.gather_rows(src, idx).clone()
                    check(torch.equal(got, want) and torch.equal(
                        got, K.rows.gather_rows(src, idx)),
                        f"gather_rows D={d} B={b} offset={offset} "
                        f"equal={equal}: not bitwise its plain version")
                    n += 1
    return n


def k5_calls(torch, tiers, ids, dev):
    """The two K5 launches of one ``TieredFeatures.gather_rows`` call over
    ``ids`` (the cold gather from the uploaded rows, whose pad row serves
    the hot ids, and the hot gather from the table, whose row 0 serves the
    cold ids) as ``(src, idx)`` pairs, with the hot and cold row counts."""
    pos = np.nonzero(ids >= 0)[0]
    live = ids[pos]
    slots = tiers.cache.slots(live)
    hot = slots >= 0
    n_cold = int((~hot).sum())
    cold_up = tiers.store.upload(live[~hot], dev, pad_rows=1)
    cold_sel = np.full(ids.size, n_cold, np.int32)
    cold_sel[pos[~hot]] = np.arange(n_cold, dtype=np.int32)
    hot_sel = np.zeros(ids.size, np.int32)
    hot_sel[pos[hot]] = slots[hot]
    calls = [(cold_up, torch.from_numpy(cold_sel).to(dev)),
             (tiers.cache.table, torch.from_numpy(hot_sel).to(dev))]
    return calls, int(hot.sum()), n_cold


def k5_bytes(K, calls):
    """K5's bound in bytes over ``calls``: the distinct rows read once
    each, the ids, the rows written (kernels/cost.py)."""
    return sum(K.cost.gather_rows(K.cost.host(idx), src.shape[1]).bytes
               for src, idx in calls)


def _held_ms(torch, fn, n, spin=K5_HOLD_CYCLES):
    """``n`` calls of ``fn`` enqueued while a spin kernel holds the stream,
    so that the card runs them from a full queue and no host time between
    launches is counted: (each call's ms between its own events, their
    mean back to back, whether the spin outlasted the enqueue)."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    for e in ev[:-1]:
        e.record()
        fn()
    ev[-1].record()
    queued = not ev[0].query()
    torch.cuda.synchronize()
    each = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    return each, ev[0].elapsed_time(ev[-1]) / n, queued


def time_gather_rows(torch, K, tiers, ids, rate, dev):
    """Time one ``gather_rows`` call's worth of K5 (the cold gather and the
    hot gather of one step's outermost block) at the sampled shapes."""
    ref = K.ref
    calls, n_hot, n_cold = k5_calls(torch, tiers, ids, dev)
    longs = [idx.long() for _, idx in calls]
    err = 0.0
    for src, idx in calls:
        got, want = K.rows.gather_rows(src, idx), ref.gather_rows_ref(src, idx)
        check(torch.equal(got, want),
              "gather_rows at the sampled shapes != its plain version")
        err = max(err, (got - want).abs().max().item())

    def k5():
        for src, idx in calls:
            K.rows.gather_rows(src, idx)

    def plain():
        for src, idx in calls:
            ref.gather_rows_ref(src, idx)

    def lib():
        for (src, _), idx in zip(calls, longs):
            torch.index_select(src, 0, idx)

    with torch.inference_mode():
        t_plain = _time(torch, plain)
        t_k5 = _time(torch, k5)
        t_lib = _time(torch, lib)
        each = _each_ms(torch, k5, K5_MEDIAN_CALLS)
        dev_each, t_dev, q_k5 = _held_ms(torch, k5, K5_MEDIAN_CALLS)
        _, t_dev_lib, q_lib = _held_ms(torch, lib, K5_MEDIAN_CALLS)
    check(q_k5 and q_lib,
          "K5's timing: the spin kernel ended before the calls were queued")
    d = calls[0][0].shape[1]
    nbytes = k5_bytes(K, calls)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [dict(K.rows.plan(int(idx.numel()), d, sms, K.rows.blocks_per_sm(
        dev.index, 4))._asdict(), unroll=K.rows.UNROLL,
        threads=K.rows.THREADS) for _, idx in calls]
    return dict(name="gather_rows", route="cuda", source=SOURCE["gather_rows"],
                replaces=REPLACES["gather_rows"], max_abs_err=err,
                ms=t_k5, plain_ms=t_plain, bound_ms=nbytes / rate * 1e3,
                bound_by="bytes", library_ms=t_lib, library="index_select",
                bytes=nbytes, bytes_per_s=nbytes / (t_k5 / 1e3),
                plan=plans, rows=int(ids.size), hot_rows=n_hot,
                cold_rows=n_cold, width=d,
                ms_median=float(np.median(each)),
                ms_quartiles=[float(np.percentile(each, q))
                              for q in (25, 75)],
                ms_median_of=f"{K5_MEDIAN_CALLS} calls (2 launches each: "
                             "the cold and the hot gather), each timed "
                             "alone by CUDA events",
                device_ms=t_dev, device_library_ms=t_dev_lib,
                device_bytes_per_s=nbytes / (t_dev / 1e3),
                device_ms_median=float(np.median(dev_each)),
                device_ms_quartiles=[float(np.percentile(dev_each, q))
                                     for q in (25, 75)],
                device_ms_of=f"the same {K5_MEDIAN_CALLS} calls enqueued "
                             "while a spin kernel holds the stream, so the "
                             "card runs them from a full queue and the "
                             "host's time between launches does not count: "
                             "each between its own events (median, "
                             "quartiles) and back to back (mean)")


# ---------------------------------------------------------------------------
# the online tuner on the card (phase 13)
# ---------------------------------------------------------------------------

def _gcn_step(C, value_and_grad, adamw_update, ocfg):
    """One full-graph GCN AdamW step on ``eng`` over padded ``tables``."""
    def step(eng, tables, p, opt):
        xp, yp, mp = tables
        loss, grads = value_and_grad(lambda q: C.masked_cross_entropy(
            C.gcn_apply(q, eng, xp), yp, mp), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        return p, opt, loss
    return step


def _held_to_plain(torch, K, eng, xs, what):
    """Each layer's GCN aggregation on ``eng`` (the kernels) held to the
    plain path on the same plan and arrays (rtol/atol 1e-5) and, where a
    layer runs K2, bitwise to K1 on that plan: the check of each config a
    tuner runs K1 or K2 at.  Returns the largest difference and the
    launches the check made, which the path's counts leave out."""
    before = K.launch_counts()
    plain = dataclasses.replace(eng, use_kernel=False)
    on_k1 = dataclasses.replace(eng, layer_plans=[
        dataclasses.replace(lp, pb=None) for lp in eng.layer_plans])
    err = 0.0
    with torch.inference_mode():
        for i, x in enumerate(xs):
            got = eng.gcn_norm_aggregate(x, layer=i)
            err = max(err, held(got, plain.gcn_norm_aggregate(x, layer=i),
                                f"{what}, layer {i}"))
            if eng.layer_plan(i).pb:
                check(torch.equal(got, on_k1.gcn_norm_aggregate(x, layer=i)),
                      f"{what}, layer {i}: K2 not bitwise K1")
    torch.cuda.synchronize()
    after = K.launch_counts()
    return err, {k: after[k] - before[k] for k in after}


def _layer_inputs(widths, table):
    """One input a layer at the widths the GCN aggregates: the padded
    feature table's leading columns."""
    return [table[:, :w].contiguous() for w in widths]


def tuner_on_card(torch, C, K, g, ring, dev, ncls, launches):
    """Phase 13: the online tuner driving K1/K2 on the card."""
    import gc

    from repro_torch.core.autotune import H100_SXM
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)
    from repro_torch.train.tree import tree_map

    t_phase = time.perf_counter()
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        hidden=16, num_layers=2, device=dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=200,
                       weight_decay=0.0)
    step = _gcn_step(C, value_and_grad, adamw_update, ocfg)
    cache = os.path.join(ROOT, "build", "tuner", "phase13.json")
    if os.path.exists(cache):
        os.remove(cache)          # the search starts cold in every run
    torch.cuda.synchronize()
    widths = C.aggregation_widths("gcn", params)
    # each config the search runs is held to the plain path on its plan;
    # those launches are not the path's
    excluded = {}

    def hold(eng, tables, what):
        err, made = _held_to_plain(torch, K, eng,
                                   _layer_inputs(widths, tables[0]), what)
        for k, n in made.items():
            excluded[k] = excluded.get(k, 0) + n
        return err

    def path_counts():
        return {k: n - excluded.get(k, 0)
                for k, n in K.launch_counts().items()}

    k2 = lambda: path_counts()["gather_sum_blocked"]

    # -- (a) the global search over training steps --------------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dyn = DynamicGNNEngine.build(
        g, ring, d_feat=d_in, ps_space=TUNER_PS, dist_space=TUNER_DIST,
        pb_space=TUNER_PB, use_kernel=True, hw=H100_SXM,
        budget=TUNER_BUDGET, window=ProfileConfig(warmup=1, iters=3),
        cache_path=cache)
    tables = _tables(torch, C, dyn, x, y, train_mask, dev)
    moves = []
    build_s = time.perf_counter() - t0
    cur = dict(config=dyn.config, build_s=build_s,
               plain_max_abs_err=hold(dyn.engine, tables, dyn.config),
               steps=0, k2=k2())
    t_search, n_steps = time.perf_counter(), 0
    while not dyn.committed:
        check(n_steps < 40 * TUNER_BUDGET, "the tuner's search never closed")
        t0 = time.perf_counter()
        params, opt, _ = step(dyn, tables, params, opt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_steps += 1
        cur["steps"] += 1
        t0 = time.perf_counter()
        moved = dyn.observe_step(dt)
        if moved:
            tables = None            # the old layout's tables go first
            tables = _tables(torch, C, dyn, x, y, train_mask, dev)
        if moved or dyn.committed:
            build_s = time.perf_counter() - t0
            cur["k2_launched"] = k2() > cur.pop("k2")
            moves.append(cur)
            cur = dict(config=dyn.config, build_s=build_s,
                       plain_max_abs_err=(hold(dyn.engine, tables, dyn.config)
                                          if moved else
                                          moves[-1]["plain_max_abs_err"]),
                       steps=0, k2=k2())
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t_search
    commit_build_s = cur["build_s"]      # the committed config's rebuild
    launches["tuner"] = counts = path_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["tuner"]),
          f"a kernel of the tuner's path never launched: {counts}")
    committed = dyn.config
    probes = [dict(config=ev["config"], ms=ev["latency"] * 1e3,
                   model_error=dyn._model_error(ev))
              for ev in dyn.audit if ev["event"] == "probe"]
    check(len(probes) == dyn.tuner.measured <= TUNER_BUDGET
          and all(np.isfinite(pr["ms"]) and pr["ms"] > 0 for pr in probes),
          f"bad probes: {probes}")
    for mv, pr in zip(moves, probes):   # a move's window is its probe
        check(mv["config"] == pr["config"], f"{mv} measured as {pr}")
        mv["ms"] = pr["ms"]
    say("tuner_search", spaces=dict(ps=TUNER_PS, dist=TUNER_DIST,
                                    pb=TUNER_PB),
        budget=TUNER_BUDGET, window="warmup 1, iters 3, median",
        held_to_plain="each config's aggregations, rtol/atol 1e-5; K2 "
                      "bitwise K1 on the same plan",
        hw=H100_SXM.name, moves=moves, probes=probes, committed=committed,
        commit_step=n_steps, commit_build_s=commit_build_s,
        search_s=round(search_s, 3),
        events=[ev["event"] for ev in dyn.audit if ev["event"] != "probe"],
        launches=counts)

    # the hardware probes on the ring, the spec they give, and the stock
    # spec against the one fitted to the search's audit trail
    from repro_torch.obs import calibrate as cal
    probes = cal.probe_hardware(ring)
    check(all(isinstance(v, float) and math.isfinite(v) and v > 0
              for v in probes.values()), f"a probe gave no number: {probes}")
    probed = cal.spec_from_probes(H100_SXM, probes)
    fit = dyn.calibrate(adopt=False)
    check(fit is not None and fit.error <= fit.base_error,
          f"calibration: {fit}")
    say("tuner_calibration", probes=probes,
        probe_shapes=dict(matmul="4096 x 4096 fp32, TF32 off",
                          host="32 MiB pageable numpy -> card",
                          link=f"one rotation of {ring.n_dev} x 2048 x 256 "
                               "fp32 tiles, one tile's bytes"),
        probed_spec=dataclasses.asdict(probed), stock=H100_SXM.name,
        base_error=fit.base_error, error=fit.error, scales=fit.scales,
        n_observations=fit.n_observations, summary=fit.summary())

    # -- (d) memory and (b) dynamic == static from the commit step ----------
    # the bytes a fresh static engine at the committed config adds, and
    # the bytes dropping the tuned engine frees: equal unless tuner moves
    # left plan arrays behind
    tables = None
    part = dyn.partition
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    static = C.GNNEngine.build(g, ring, ps=committed["ps"],
                               dist=committed["dist"],
                               pb=committed["pb"] or None, partition=part)
    static_build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem_static = torch.cuda.memory_allocated() - mem_before
    runs = []
    for eng in (dyn, static):
        q, o = tree_map(torch.clone, params), tree_map(torch.clone, opt)
        tb = _tables(torch, C, eng, x, y, train_mask, dev)
        losses = []
        for _ in range(3):
            q, o, loss = step(eng, tb, q, o)
            losses.append(loss)
        runs.append((losses, q))
        del tb, q, o
    check(all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
          and _bitwise(torch, runs[0][1], runs[1][1]),
          "the tuned engine and a static one at its config differ")
    del runs, eng
    torch.cuda.synchronize()
    mem_both = torch.cuda.memory_allocated()
    del dyn
    gc.collect()       # the tuner's audit sink refers back to the engine
    torch.cuda.synchronize()
    mem_dyn = mem_both - torch.cuda.memory_allocated()
    check(abs(mem_dyn - mem_static) <= 0.1 * mem_static,
          f"the tuned engine held {mem_dyn} bytes, a static one adds "
          f"{mem_static}: tuner moves leaked plan arrays")

    # step time at the default config and the committed one (CUDA events)
    # and, at the committed (ps, dist), K1 (pb 0) against K2 (pb 4, 8),
    # each held to the plain path first
    tb = _tables(torch, C, static, x, y, train_mask, dev)
    step_ms_by_pb, plain_err_by_pb = {}, {}
    for pb in TUNER_PB:
        e = dataclasses.replace(static, layer_plans=[
            dataclasses.replace(lp, pb=pb or None)
            for lp in static.layer_plans])
        plain_err_by_pb[pb], _ = _held_to_plain(
            torch, K, e, _layer_inputs(widths, tb[0]), f"committed plan, "
            f"pb {pb}")
        step_ms_by_pb[pb] = _time(torch, lambda: step(e, tb, params, opt),
                                  reps=10, warmup=3)
    committed_ms = step_ms_by_pb[committed["pb"]]
    default = dict(ps=16, dist=2, pb=0)
    if committed == default:
        default_ms = committed_ms
    else:
        dflt = shared_engine(C, g, ring)
        tbd = _tables(torch, C, dflt, x, y, train_mask, dev)
        default_ms = _time(torch, lambda: step(dflt, tbd, params, opt),
                           reps=10, warmup=3)
        del dflt, tbd
    say("tuner_committed", committed=committed, default=default,
        dynamic_equals_static="bitwise, 3 AdamW steps from the commit "
                              "step (losses and parameters)",
        default_step_ms=default_ms, committed_step_ms=committed_ms,
        step_ms_by_pb=step_ms_by_pb, plain_max_abs_err_by_pb=plain_err_by_pb,
        engine_bytes_tuned=mem_dyn, engine_bytes_static=mem_static,
        memory_tolerance="within 10 %",
        static_build_s=round(static_build_s, 3))

    # -- (c) per-layer == single-plan, bitwise; a per-layer search -----------
    per = C.GNNEngine.build(g, ring, layer_configs=[dict(
        ps=committed["ps"], dist=committed["dist"],
        pb=committed["pb"] or None)] * 2, partition=part)
    check(per.ring_arrays[0] is per.ring_arrays[1],
          "layers of one config hold two plans")
    xp = tb[0]
    got = []
    for eng in (static, per):
        with torch.inference_mode():
            logits = C.gcn_apply(params, eng, xp)
        _, grads = value_and_grad(lambda q: C.masked_cross_entropy(
            C.gcn_apply(q, eng, tb[0]), tb[1], tb[2]), params)
        got.append((logits, grads))
    check(torch.equal(got[0][0], got[1][0])
          and _bitwise(torch, got[0][1], got[1][1]),
          "per-layer engine != single-plan engine")
    del per, got, tb, xp, static
    per_layer = tuner_per_layer(torch, C, K, dev, ncls, H100_SXM)

    # -- (e) serving with drift retuning ------------------------------------
    serving = tuner_serving(torch, C, K, dev, ncls, H100_SXM, launches)
    # -- (f) the sampled branch's fanout / batch search ---------------------
    sampled = tuner_sampled(torch, C, K, g, ring, dev, ncls, launches)
    torch.cuda.synchronize()
    say("tuner_done", per_layer_equals_single_plan="bitwise (logits, one "
        "step's gradients)", per_layer=per_layer, serving=serving,
        sampled=sampled, phase_s=round(time.perf_counter() - t_phase, 3))
    return part


def tuner_sampled(torch, C, K, g, ring, dev, ncls, launches):
    """Phase 13 (f): the sampled branch's search, as the training
    launcher's ``--dynamic-tune --model sage`` runs it
    (``launch/train_gnn.py``: one idle ring plan, fanout and batch tuned)
    on the full stand-in: SAGE 32 x 2 over the pinned tiered store (a hot
    cache of N // 8 rows), ``SAMPLED_FANOUT`` x ``SAMPLED_BATCH`` with a
    budget of 4 and a window of 1 + 2 steps fed the per-seed step time;
    each config's first K5 assembly held bitwise to ``x[ids]``."""
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.sample import block_tree, sample_blocks, seed_batches
    from repro_torch.store import FeatureStore, TieredFeatures
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    n, d_in = g.num_nodes, 100
    x, y, train_mask = graph_features(n, d_in, ncls, seed=0)
    tiers = TieredFeatures(FeatureStore(x, copy=False, pin=True), None,
                           n // 8, device=dev)
    tiers.admit(np.argsort(-np.diff(g.indptr))[: n // 8])
    params = C.sage_init(torch.Generator().manual_seed(0), d_in, ncls,
                         hidden=32, num_layers=2, device=dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=200,
                       weight_decay=0.0)
    dyn = DynamicGNNEngine.build(
        g, ring, d_feat=d_in, ps_space=(8,), dist_space=(1,), pb_space=(0,),
        fanout_space=SAMPLED_FANOUT, batch_space=SAMPLED_BATCH, budget=4,
        window=ProfileConfig(warmup=1, iters=2))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    train_ids = np.nonzero(train_mask)[0]

    def minibatches(batch):
        while True:
            yield from seed_batches(train_ids, batch, rng=rng)

    fanout, batch = dyn.sample_fanout, dyn.sample_batch
    batches = minibatches(batch)
    held, n_steps = {}, 0
    t_search = time.perf_counter()
    K.reset_launch_counts()
    while not dyn.committed:
        check(n_steps < 100, "the sampled search never closed")
        seeds, valid = next(batches)
        t1 = time.perf_counter()
        blocks = sample_blocks(g, seeds, [fanout, fanout], batch=batch,
                               rng=rng)
        h0 = tiers.gather_rows(blocks[0].src_ids)
        bt = block_tree(blocks, dev)
        yb = torch.from_numpy(y[np.clip(seeds, 0, None)]).to(dev)
        mb = torch.from_numpy(valid).to(dev)
        _, grads = value_and_grad(lambda p: C.masked_cross_entropy(
            C.apply_blocks("sage", p, h0, bt), yb, mb), params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        n_steps += 1
        if (fanout, batch) not in held:   # K5's assembly, bitwise x[ids]
            ids = blocks[0].src_ids
            want = np.where((ids >= 0)[:, None], x[np.maximum(ids, 0)], 0.0)
            check(np.array_equal(h0.cpu().numpy(), want),
                  f"sampled search: gather_rows != x[ids] at fanout "
                  f"{fanout}, batch {batch}")
            held[(fanout, batch)] = int(ids.size)
        if dyn.observe_step(dt / batch):
            fanout, batch = dyn.sample_fanout, dyn.sample_batch
            batches = minibatches(batch)
    torch.cuda.synchronize()
    launches["tuner_sampled"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["tuner_sampled"]),
          f"a kernel of the sampled search never launched: {counts}")
    check(dyn.config["fanout"] in SAMPLED_FANOUT
          and dyn.config["batch"] in SAMPLED_BATCH,
          f"bad sampled config {dyn.config}")
    probes = [dict(config=ev["config"], us_per_seed=ev["latency"] * 1e6)
              for ev in dyn.audit if ev["event"] == "probe"]
    return dict(nodes=n, committed=dyn.config, measured=dyn.tuner.measured,
                steps=n_steps, probes=probes,
                gather_rows_bitwise={f"fanout {f}, batch {b}": rows
                                     for (f, b), rows in held.items()},
                store=tiers.report(), launches=counts,
                build_s=round(build_s, 3),
                search_s=round(time.perf_counter() - t_search, 3))


def tuner_per_layer(torch, C, K, dev, ncls, hw):
    """Phase 13 (c): a per-layer search (budget 16) on the reduced
    stand-in, over GCN training steps."""
    from repro_torch.dist import VirtualRing
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    g, _ = C.paper_dataset("products", scale=TUNER_SCALE, seed=0)
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        hidden=16, num_layers=2, device=dev)
    opt = adamw_init(params)
    step = _gcn_step(C, value_and_grad, adamw_update, AdamWConfig(
        lr=5e-3, warmup_steps=5, total_steps=200, weight_decay=0.0))
    t0 = time.perf_counter()
    dyn = DynamicGNNEngine.build(
        g, VirtualRing(8, dev), d_feat=d_in,
        layer_dims=C.aggregation_widths("gcn", params),
        ps_space=TUNER_PS, dist_space=TUNER_DIST, pb_space=TUNER_PB,
        use_kernel=True, hw=hw, budget=16,
        window=ProfileConfig(warmup=1, iters=2))
    tables = _tables(torch, C, dyn, x, y, train_mask, dev)
    widths = C.aggregation_widths("gcn", params)
    hold = lambda: _held_to_plain(torch, K, dyn.engine, _layer_inputs(
        widths, tables[0]), dyn.config)[0]
    err = hold()
    n = 0
    while not dyn.committed:
        check(n < 400, "the per-layer search never closed")
        t1 = time.perf_counter()
        params, opt, _ = step(dyn, tables, params, opt)
        torch.cuda.synchronize()
        n += 1
        if dyn.observe_step(time.perf_counter() - t1):
            tables = None
            tables = _tables(torch, C, dyn, x, y, train_mask, dev)
            err = max(err, hold())
    check(len(dyn.config["layers"]) == 2, "not a per-layer config")
    return dict(nodes=g.num_nodes, widths=dyn.layer_dims,
                committed=dyn.config["layers"],
                measured=dyn.tuner.measured, steps=n,
                best_ms=dyn.tuner.best_latency * 1e3,
                plain_max_abs_err=err,
                s=round(time.perf_counter() - t0, 3))


def tuner_serving(torch, C, K, dev, ncls, hw, launches):
    """Phase 13 (e): GCN serving through a DynamicGNNEngine on the
    reduced stand-in (a full-size trace retuned 4 times at 5-6 s a
    rebuild); a hot-set rotation must retune, and served logits equal the
    offline forward bitwise after it."""
    from repro_torch.dist import VirtualRing
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.serve import (GNNServeEngine, TrafficPhase,
                                   WorkloadStats, ZipfTraffic, run_trace)

    g, _ = C.paper_dataset("products", scale=TUNER_SCALE, seed=0)
    d_in = 100
    x = np.random.default_rng(0).normal(size=(g.num_nodes, d_in)).astype(
        np.float32)
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        device=dev)
    t0 = time.perf_counter()
    dyn = DynamicGNNEngine.build(
        g, VirtualRing(8, dev), d_feat=d_in, ps_space=(4, 8, 16),
        dist_space=(1, 2), pb_space=(0, 4), use_kernel=True, hw=hw,
        window=ProfileConfig(warmup=1, iters=2))
    srv = GNNServeEngine(dyn, params, "gcn", x, g, slots=8,
                         stats=WorkloadStats(window=32), check_every=8,
                         min_records=8)
    phases = [TrafficPhase(requests=200, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.02),
              TrafficPhase(requests=200, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.02)]
    events = list(ZipfTraffic(g.num_nodes, d_in, phases, seed=0))
    n_requests = sum(not ev.is_update for ev in events)
    K.reset_launch_counts()
    results = run_trace(srv, events)
    torch.cuda.synchronize()
    launches["tuner_serving"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["tuner_serving"]),
          f"a kernel of the tuned serving path never launched: {counts}")
    rep = srv.report()
    check(len(results) == rep["served"] == n_requests,
          f"{n_requests} requests, {len(results)} answered")
    check(rep["retunes"] >= 1, "the hot-set rotation caused no retune")
    # close the open search on more traffic, then hold the config
    extra = ZipfTraffic(g.num_nodes, d_in, [TrafficPhase(
        requests=50, alpha=1.1, rate=200.0, seeds_max=4)], seed=1)
    for _ in range(20):
        if not srv._tuning:
            break
        run_trace(srv, extra)
    check(not srv._tuning, "the retuned search never closed")
    srv.check_every = 10 ** 9
    seeds = np.unique(np.concatenate([r.seeds for r in results[-3:]]))[:8]
    srv.cache.invalidate()
    srv.submit(seeds)
    (full,) = srv.step()
    srv.submit(seeds)
    (cached,) = srv.step()
    check(not full.cached and cached.cached, "full/cached passes not taken")
    with torch.inference_mode():
        offline = C.gcn_apply(params, dyn, srv.xp)
    rows = torch.from_numpy(C.pgas_rows(dyn.plan, seeds).astype(
        np.int64)).to(dev)
    off_rows = offline[rows].cpu().numpy()
    check(np.array_equal(full.logits, off_rows)
          and np.array_equal(cached.logits, off_rows),
          "served != offline after the retune")
    # the committed config's logits against the plain path (as phase 3),
    # and every config the trace ran rebuilt on its partition and held
    with torch.inference_mode():
        plain = C.gcn_apply(params, dataclasses.replace(
            dyn.engine, use_kernel=False), srv.xp)
    check(torch.allclose(offline, plain, rtol=2e-4, atol=1e-5),
          "tuned serving: kernel path != plain path")
    logits_err = (offline - plain).abs().max().item()
    del offline, plain
    widths = C.aggregation_widths("gcn", params)
    ran = []
    for _, cfg in dyn.history:
        if cfg not in ran:
            ran.append(cfg)
    err = 0.0
    for cfg in ran:
        eng = dyn._build_engine(cfg)
        xs = _layer_inputs(widths, eng.shard(eng.pad(x)))
        err = max(err, _held_to_plain(torch, K, eng, xs, cfg)[0])
        del eng, xs
    lat = np.array([r.latency for r in results])
    return dict(nodes=g.num_nodes, requests=len(results),
                retunes=rep["retunes"], rebuilds=rep["rebuilds"],
                search_sizes=rep["search_sizes"], config=dyn.config,
                events=[ev["event"] for ev in dyn.audit
                        if ev["event"] != "probe"],
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                served_equals_offline="bitwise (full, cached) after the "
                                      "retune",
                plain_logits_max_abs_err=logits_err,
                plain_logits_tolerance="rtol 2e-4 atol 1e-5",
                configs_held=len(ran), plain_max_abs_err=err,
                launches=counts, s=round(time.perf_counter() - t0, 3))


# ---------------------------------------------------------------------------
# tiered serving and the streamed ring (phase 14)
# ---------------------------------------------------------------------------

def _overlap_ms(a, b):
    """The length of the intersection of two (start, end) ms intervals."""
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def stream_timeline(torch, C, tiers, eng):
    """One streamed pass with CUDA events on both streams: each ring's
    interval on the current stream (from after its chunk's assembly to
    the next fetch, which is issued as soon as the ring is enqueued) and
    each upload's on the copy stream, all from one base event; the host's
    time in each fetch beside them."""
    base = torch.cuda.Event(enable_timing=True)
    marks, fetch_s = {}, []

    def mark(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[key] = e

    def fetch(c):
        mark(("ring_end", c - 1))
        t0 = time.perf_counter()
        chunk = tiers.device_chunk(c)
        fetch_s.append(time.perf_counter() - t0)
        mark(("ring_start", c))
        return chunk

    tiers.copy_log = []
    torch.cuda.synchronize()
    base.record()
    out = C.mgg_aggregate_streamed(fetch, eng.plan, eng.ring,
                                   arrays=eng.stream_arrays(0))
    mark(("ring_end", eng.plan.dist - 1))
    torch.cuda.synchronize()
    log, tiers.copy_log = tiers.copy_log, None
    at = lambda e: base.elapsed_time(e)
    copies = [dict(start_ms=at(c["start"]), end_ms=at(c["end"]),
                   bytes=c["bytes"]) for c in log]
    rings = [(at(marks[("ring_start", c)]), at(marks[("ring_end", c)]))
             for c in range(eng.plan.dist)]
    for c, cp in enumerate(copies):
        cp["ms"] = cp["end_ms"] - cp["start_ms"]
        cp["h2d_gb_per_s"] = cp["bytes"] / max(cp["ms"], 1e-9) / 1e6
        cp["host_fetch_ms"] = fetch_s[c] * 1e3
        if c:   # the copy of chunk c hides behind ring c - 1
            cp["overlap_with_ring_ms"] = _overlap_ms(
                (cp["start_ms"], cp["end_ms"]), rings[c - 1])
    return out, dict(rings_ms=[r[1] - r[0] for r in rings],
                     ring_intervals_ms=rings, copies=copies,
                     pass_ms=at(marks[("ring_end", eng.plan.dist - 1)]))


def tiered_streaming(torch, C, K, g, ring, dev, x, part, ncls, rate,
                     launches):
    """Phase 14: the streamed ring and tiered serving at full size."""
    from repro_torch.core.pipeline import mgg_aggregate
    from repro_torch.launch import serve_gnn
    from repro_torch.serve import (GNNServeEngine, TrafficPhase,
                                   WorkloadStats, ZipfTraffic, run_trace)
    from repro_torch.store import FeatureStore, TieredFeatures

    t_phase = time.perf_counter()
    n, d = x.shape
    store = FeatureStore(x, copy=False, pin=True)
    eng = shared_engine(C, g, ring)
    arrays = eng.stream_arrays(0)
    plan, dist = eng.plan, eng.plan.dist
    hot = np.argsort(-g.degrees, kind="stable")
    caps = (0, n // 8, n)
    build_s = time.perf_counter() - t_phase

    def tiers_at(cap):
        t = TieredFeatures(store, plan, cap, device=dev)
        if cap:
            t.admit(hot[:cap])
        return t

    # the resident ring over the resident padded table, and its time
    xp = eng.shard(eng.pad(x))
    with torch.inference_mode():
        resident = mgg_aggregate(xp, plan, ring, arrays=eng.ring_arrays[0])
        resident_ms = _time(torch, lambda: mgg_aggregate(
            xp, plan, ring, arrays=eng.ring_arrays[0]), reps=5)
    tiers = {cap: tiers_at(cap) for cap in caps}

    # (a) the main path: one streamed pass a capacity, counted
    outs, stats, streamed = {}, {}, {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with torch.inference_mode():
        for cap in caps:
            before = tiers[cap].report()["host_bytes_streamed"]
            stats[cap] = {}
            outs[cap] = eng.aggregate_streamed(tiers[cap], stats=stats[cap])
            streamed[cap] = tiers[cap].report()["host_bytes_streamed"] \
                - before
    torch.cuda.synchronize()
    launches["tiered"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["tiered"]),
          f"a kernel of the streamed ring never launched: {counts}")
    K.reset_launch_counts()
    with torch.inference_mode():
        sparse = {cap: eng.aggregate_streamed(tiers[cap], topk=d)
                  for cap in caps}
    torch.cuda.synchronize()
    launches["tiered_sparse"] = sparse_counts = K.launch_counts()
    check(all(sparse_counts[k] > 0 for k in PATH_KERNELS["tiered_sparse"]),
          f"a kernel of the top-k streamed ring never launched: "
          f"{sparse_counts}")
    bits = lambda t: t.view(torch.int32)
    for cap in caps:
        check(torch.equal(bits(outs[cap]), bits(outs[0])),
              f"the streamed ring at capacity {cap} != at capacity 0")
        check(torch.equal(bits(sparse[cap]), bits(outs[cap])),
              f"the top-k streamed ring at k = D != the dense one, cap {cap}")
        check(stats[cap]["prefetch_issued"] == dist - 1,
              f"prefetches issued at cap {cap}: {stats[cap]}")
        with torch.inference_mode():
            check(torch.equal(bits(tiers[cap].padded_table()), bits(xp)),
                  f"padded_table != pad(x) at capacity {cap}")
    # against the resident ring: the sums are associated differently, so
    # each entry is held within 1e-5 of its row's sum of magnitudes
    # (A|x|); entries outside elementwise rtol/atol 1e-5 are counted
    with torch.inference_mode():
        scale = mgg_aggregate(xp.abs(), plan, ring, arrays=eng.ring_arrays[0])
    diff = (outs[0] - resident).abs()
    err = diff.max().item()
    err_scaled = (diff / scale.clamp_min(1e-30)).max().item()
    outside = int((~torch.isclose(outs[0], resident, rtol=1e-5,
                                  atol=1e-5)).sum())
    check(bool((diff <= 1e-5 * scale + 1e-5).all()),
          f"streamed ring against the resident one: {err} (scaled "
          f"{err_scaled})")
    del sparse, resident, scale, diff

    # (b) numbers: each capacity's pass, and one pass's event timeline
    ms_by_cap, timeline = {}, {}
    with torch.inference_mode():
        for cap in caps:
            ms_by_cap[cap] = _time(torch, lambda: eng.aggregate_streamed(
                tiers[cap]), reps=3, warmup=1)
        for cap in (0, n // 8):
            got, timeline[cap] = stream_timeline(torch, C, tiers[cap], eng)
            check(torch.equal(bits(got), bits(outs[0])),
                  "the timed streamed pass changed the bits")
    copies = [cp for cap in timeline for cp in timeline[cap]["copies"]]
    h2d = max(cp["h2d_gb_per_s"] for cp in copies) * 1e9
    floor_ms = {cap: max(resident_ms, streamed[cap] / h2d * 1e3)
                for cap in caps}
    # the fetches never wait for the card: with a spin kernel holding it
    # for about 3 x a pass, every prefetch returns while its ring is
    # still unfinished
    spin = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda._sleep(int(3 * max(ms_by_cap.values()) * 1e-3 * 2.0e9))
        eng.aggregate_streamed(tiers[n // 8], stats=spin)
    torch.cuda.synchronize()
    check(spin["prefetch_inflight"] == dist - 1,
          f"a fetch waited for the card: {spin}")
    say("tiered_ring", nodes=n, d=d, shards=ring.n_dev,
        config=dict(ps=STREAM_PS, dist=STREAM_DIST), build_s=round(
            build_s, 3), capacities=list(caps),
        bitwise_across_capacities=True, padded_table="bitwise pad(x)",
        sparse_k_equals_d="bitwise the dense streamed ring",
        resident_max_abs_err=err, resident_max_err_over_sum_abs=err_scaled,
        resident_outside_rtol_atol_1e5=outside,
        tolerance="|streamed - resident| <= 1e-5 * (A|x|) + 1e-5",
        prefetch=stats[0], prefetch_with_card_held=spin,
        launches=counts, sparse_launches=sparse_counts,
        resident_ms=resident_ms, streamed_ms_by_capacity=ms_by_cap,
        host_bytes_streamed_by_capacity=streamed,
        h2d_bytes_per_s=h2d, floor_ms_by_capacity=floor_ms,
        timeline_by_capacity=timeline)

    # (c) K5 at the padded table's shape (capacity N // 8)
    ids = np.full(plan.padded_nodes, -1, np.int64)
    for ch_ids, _, fpos in tiers[n // 8]._chunks:
        ids[fpos] = ch_ids
    k5 = time_gather_rows(torch, K, tiers[n // 8], ids, rate, dev)
    del tiers, outs, xp

    # (d) tiered serving at capacity N // 8 against resident serving
    init, apply, kw = C.MODEL_ZOO["gcn"]
    params = init(torch.Generator().manual_seed(0), d, ncls, device=dev,
                  **kw)
    phases = [TrafficPhase(requests=100, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.05),
              TrafficPhase(requests=100, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.05)]
    events = list(ZipfTraffic(n, d, phases, seed=0))
    served, reports = {}, {}
    for cap in (None, n // 8):
        srv = GNNServeEngine(eng, params, "gcn", x, g, slots=8,
                             stats=WorkloadStats(window=32),
                             feature_capacity=cap,
                             feature_store=None if cap is None else
                             FeatureStore(x, pin=True))
        if cap is not None:
            K.reset_launch_counts()
        t0 = time.perf_counter()
        served[cap] = run_trace(srv, events)
        torch.cuda.synchronize()
        reports[cap] = dict(srv.report(), serve_s=round(
            time.perf_counter() - t0, 3))
        if cap is not None:
            launches["tiered_serving"] = serve_counts = K.launch_counts()
            check(srv.xp is None, "tiered serving held a padded table")
        del srv
    check(all(serve_counts[k] > 0 for k in PATH_KERNELS["tiered_serving"]),
          f"a kernel of tiered serving never launched: {serve_counts}")
    n_req = sum(not ev.is_update for ev in events)
    check(len(served[None]) == len(served[n // 8]) == n_req,
          "tiered serving dropped requests")
    for a, b in zip(served[None], served[n // 8]):
        check(a.cached == b.cached and np.array_equal(a.logits, b.logits),
              "tiered serving logits != resident serving logits")
    tiered_lat = np.array([r.latency for r in served[n // 8]])
    resident_lat = np.array([r.latency for r in served[None]])
    say("tiered_serving", nodes=n, capacity=n // 8, requests=n_req,
        updates=sum(ev.is_update for ev in events),
        full_passes=sum(not r.cached for r in served[n // 8]),
        equals_resident="bitwise (full and cached passes)",
        tiered_p50_ms=float(np.percentile(tiered_lat, 50) * 1e3),
        tiered_p99_ms=float(np.percentile(tiered_lat, 99) * 1e3),
        resident_p50_ms=float(np.percentile(resident_lat, 50) * 1e3),
        resident_p99_ms=float(np.percentile(resident_lat, 99) * 1e3),
        tiers=reports[n // 8]["tiers"], serve_s=reports[n // 8]["serve_s"],
        resident_serve_s=reports[None]["serve_s"], launches=serve_counts)
    del served, eng, store

    # (e) the launcher's streamed profile (--feature-capacity, --trace)
    trace = os.path.join(ROOT, "build", "serve_gnn_tiered_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    rep = serve_gnn.main(["--scale", "1", "--requests", "30", "--rotate",
                          "--devices", "8", "--feature-capacity", "1536",
                          "--trace", trace])
    prof = rep["pipeline_profile"]
    # the launcher serves at dist 1: one chunk, nothing to prefetch
    check(rep["served"] > 0 and rep["tiers"] is not None and prof
          and prof["prefetch_issued"] == 0
          and 0.0 <= prof["overlap_efficiency"] <= 1.0,
          f"the tiered launcher: {rep.get('tiers')}, {prof}")
    say("tiered_launcher", served=rep["served"], tiers=rep["tiers"],
        pipeline_profile=prof,
        phase_s=round(time.perf_counter() - t_phase, 3))
    return k5


# ---------------------------------------------------------------------------
# the serving cluster (phase 15)
# ---------------------------------------------------------------------------

def _first_requests(events, n):
    """The events up to and including the ``n``-th request."""
    out, k = [], 0
    for ev in events:
        out.append(ev)
        k += not ev.is_update
        if k == n:
            return out
    fail(f"the trace holds {k} requests, not {n}")


def _tag_epochs(cluster):
    """Tag each served result with the number of feature updates applied
    before its batch ran: wraps each replica's ``step`` and the cluster's
    update fan-out.  Returns ``(epoch of (replica, local request id),
    the updates in order)``."""
    epoch_of, updates = {}, []
    for i, srv in enumerate(cluster.replicas):
        def step(i=i, step=srv.step):
            out = step()
            for r in out:
                epoch_of[(i, r.request_id)] = len(updates)
            return out
        srv.step = step
    fan = cluster.update_features

    def update(node, value):
        updates.append((int(node), np.asarray(value, np.float32)))
        return fan(node, value)
    cluster.update_features = update
    return epoch_of, updates


def _held_by_epoch(torch, C, cluster, results, x, params, epoch_of,
                   updates):
    """Each result bitwise the offline forward of the replica that served
    it, over the features as they stood when its batch ran.  The replicas
    share one plan layout, so one padded table carries the updates."""
    reps = cluster.replicas
    plan0 = reps[0].eng.plan
    check(all(np.array_equal(r.eng.plan.bounds, plan0.bounds)
              and r.eng.plan.rows_per_dev == plan0.rows_per_dev
              for r in reps), "the replicas' layouts differ")
    # each replica numbers its requests in the order it was given them
    local, seen = {}, [0] * len(reps)
    for gid in sorted(r.request_id for r in results):
        i = cluster.replica_of(gid)
        local[gid] = (i, seen[i])
        seen[i] += 1
    by_epoch = {}
    for r in results:
        by_epoch.setdefault(epoch_of[local[r.request_id]], []).append(r)
    dev = reps[0].eng.device
    xp = reps[0].eng.shard(reps[0].eng.pad(x))
    applied, n_full = 0, 0
    for e in sorted(by_epoch):
        for node, value in updates[applied:e]:
            xp[int(C.pgas_rows(plan0, np.array([node]))[0])] = \
                torch.from_numpy(value).to(dev)
        applied = e
        batch = by_epoch[e]
        with torch.inference_mode():
            offline = {i: C.gcn_apply(params, reps[i].eng, xp)
                       for i in {cluster.replica_of(r.request_id)
                                 for r in batch}}
        for r in batch:
            i = cluster.replica_of(r.request_id)
            rows = torch.from_numpy(C.pgas_rows(plan0, r.seeds).astype(
                np.int64)).to(dev)
            check(np.array_equal(r.logits, offline[i][rows].cpu().numpy()),
                  f"request {r.request_id} (replica {i}, "
                  f"{'cached' if r.cached else 'full'} pass) != its "
                  f"replica's offline forward")
            n_full += not r.cached
        del offline
    return dict(epochs=len(by_epoch), full=n_full,
                cached=len(results) - n_full)


def _groups_bitwise(torch, ops, ref, eng, d, gen):
    """K1 and K3 bitwise their plain versions on every ring group of
    ``eng``'s layer-0 plan, on random rows of width ``d``."""
    plan, arrays = eng.plan, eng.ring_arrays[0]
    dev = eng.device
    table = torch.from_numpy(gen.normal(size=(plan.padded_nodes, d)).astype(
        np.float32)).to(dev)
    tiles = table[:plan.n_dev * plan.tile_rows]
    groups = [(table, grp) for grp in (arrays.local,) + arrays.local_steps
              if grp is not None] + [(tiles, grp)
                                     for grp in arrays.remote_steps]
    for buf, grp in groups:
        _k1_k3_bitwise(torch, ops, ref, buf, grp, plan.padded_nodes,
                       "a replica's ring group")
    return len(groups)


def _k1_k3_bitwise(torch, ops, ref, buf, grp, out_rows, what):
    bits = lambda t: t.view(torch.int32)
    k1 = ops.neighbor_gather_sum(buf, grp.nbrs, grp.mask)
    check(torch.equal(bits(k1), bits(ref.neighbor_gather_sum_ref(
        buf, grp.nbrs, grp.mask))), f"{what}: K1 != its plain version")
    segs = (grp.order, grp.seg_rows, grp.seg_start, grp.chunks)
    base = torch.zeros((out_rows, buf.shape[1]), device=buf.device)
    check(torch.equal(
        bits(ops.segment_add_ordered(base.clone(), k1, *segs)),
        bits(ref.segment_add_ordered_ref(base.clone(), k1, *segs))),
        f"{what}: K3 != its plain version")


def _lat_ms(results):
    lat = np.array([r.latency for r in results])
    return dict(p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3))


def cluster_phase(torch, C, K, g, x, params, part, dev, ncls, launches,
                  phase3):
    """Phase 15: the serving cluster at full width, the coordinated
    retune on the reduced stand-in, and the launcher's cluster."""
    from repro_torch.core.autotune import H100_SXM
    from repro_torch.dist import VirtualRing
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import Tracer
    from repro_torch.serve import (GNNServeEngine, LeastLoadRouter,
                                   LocalityRouter, ServeCluster,
                                   TrafficPhase, WorkloadStats, ZipfTraffic,
                                   run_trace)

    t_phase = time.perf_counter()
    n, d = x.shape
    # -- (a) 4 static replicas at full width --------------------------------
    engines, builds = [], []
    for i in range(CLUSTER_REPLICAS):
        torch.cuda.synchronize()
        mem0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        engines.append(C.GNNEngine.build(g, VirtualRing(8, dev), ps=8,
                                         dist=1, partition=part))
        torch.cuda.synchronize()
        builds.append(dict(build_s=round(time.perf_counter() - t0, 3),
                           engine_gb=round((torch.cuda.memory_allocated()
                                            - mem0) / 1e9, 3)))

    def replicas(tracers=None, which=None):
        which = range(CLUSTER_REPLICAS) if which is None else which
        return [GNNServeEngine(engines[i], params, "gcn", x, g, slots=8,
                               stats=WorkloadStats(window=32),
                               tracer=None if tracers is None
                               else tracers[k])
                for k, i in enumerate(which)]

    half = CLUSTER_REQUESTS // 2 + 10
    phases = [TrafficPhase(requests=half, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.05),
              TrafficPhase(requests=half, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.05)]
    events = _first_requests(list(ZipfTraffic(n, d, phases, seed=2)),
                             CLUSTER_REQUESTS)
    runs, counts_sum = {}, {}
    for name, router in (("locality", LocalityRouter()),
                         ("load", LeastLoadRouter())):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        cluster = ServeCluster(replicas(), router=router)
        torch.cuda.synchronize()
        serve_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
        epoch_of, updates = _tag_epochs(cluster)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = cluster.run_trace(events)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = K.launch_counts()
        rep = cluster.report()
        check(rep["dropped"] == 0 and rep["served"] == len(res)
              == CLUSTER_REQUESTS and sorted(r.request_id for r in res)
              == list(range(CLUSTER_REQUESTS)),
              f"{name} router: {rep['served']} of {CLUSTER_REQUESTS} "
              f"answered, {rep['dropped']} dropped")
        check(all(counts[k] > 0 for k in PATH_KERNELS["cluster_serving"]),
              f"a kernel of the cluster's path never launched: {counts}")
        held = _held_by_epoch(torch, C, cluster, res, x, params, epoch_of,
                              updates)
        per = rep["per_replica"]
        runs[name] = dict(
            results=res, served_by_replica=[p["served"] for p in per],
            hit_rate_by_replica=[p["cache_hit_rate"] for p in per],
            updates=len(updates), held_to_offline=held,
            serve_s=round(serve_s, 3), replicas_serving_gb=round(serve_gb, 3),
            launches=counts, **_lat_ms(res))
        for k, v in counts.items():
            counts_sum[k] = counts_sum.get(k, 0) + v
        del cluster
    launches["cluster_serving"] = counts_sum
    check(all(s > 0 for s in runs["locality"]["served_by_replica"]),
          f"a replica took no traffic: {runs['locality']}")

    # one replica: bare and untraced against a cluster of one with a
    # tracer on the cluster and on the replica, bitwise
    (bare,) = replicas(which=[0])
    res_bare = run_trace(bare, events)
    del bare
    tracer = Tracer(pid=1)
    solo = ServeCluster(replicas([tracer], which=[0]),
                        router=LocalityRouter(), tracer=Tracer())
    res_solo = solo.run_trace(events)
    del solo
    check(len(res_bare) == len(res_solo) and all(
        a.request_id == b.request_id and a.cached == b.cached
        and np.array_equal(a.logits, b.logits)
        for a, b in zip(res_bare, res_solo)),
        "a traced cluster of one != run_trace on its untraced replica")
    n_spans = sum(e["name"] == "serve.request" for e in tracer.events())
    check(n_spans == CLUSTER_REQUESTS, f"{n_spans} request spans traced")
    n_groups = _groups_bitwise(torch, ops, ref, engines[0], 16,
                               np.random.default_rng(5))
    for name in runs:
        del runs[name]["results"]
    say("cluster_serving", nodes=n, d=d, classes=ncls,
        replicas=CLUSTER_REPLICAS, config=dict(ps=8, dist=1), shards=8,
        builds=builds, requests=CLUSTER_REQUESTS,
        updates=sum(ev.is_update for ev in events), by_router=runs,
        one_replica=_lat_ms(res_bare), phase3_engine=phase3,
        cluster_of_one="traced (the cluster and its replica), bitwise "
                       f"run_trace on its untraced replica ({n_spans} "
                       "request spans)",
        served_equals_offline="bitwise, each request its replica's "
                              "forward at its batch's features",
        k1_k3_bitwise_groups=n_groups)
    del engines, res_bare, res_solo
    torch.cuda.empty_cache()

    cluster_retune(torch, C, K, dev, ncls, H100_SXM, launches)
    cluster_launcher()
    say("cluster_done", phase_s=round(time.perf_counter() - t_phase, 3))


def cluster_retune(torch, C, K, dev, ncls, hw, launches):
    """Phase 15 (b): two tuned replicas sharing one config cache on the
    reduced stand-in (a full-size rebuild takes 5-7 s, and a search makes
    several)."""
    from repro_torch.dist import VirtualRing
    from repro_torch.obs import MetricsRegistry
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.serve import (GNNServeEngine, LocalityRouter,
                                   ServeCluster, TrafficPhase, WorkloadStats,
                                   ZipfTraffic)

    t0 = time.perf_counter()
    g, _ = C.paper_dataset("products", scale=TUNER_SCALE, seed=0)
    d_in = 100
    x = np.random.default_rng(0).normal(size=(g.num_nodes, d_in)).astype(
        np.float32)
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        device=dev)
    cache = os.path.join(ROOT, "build", "tuner", "phase15.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)          # the searches start cold in every run
    registry = MetricsRegistry()

    def replica(i):
        dyn = DynamicGNNEngine.build(
            g, VirtualRing(8, dev), d_feat=d_in, ps_space=(4, 8, 16),
            dist_space=(1, 2), pb_space=(0, 4), use_kernel=True, hw=hw,
            window=ProfileConfig(warmup=1, iters=2), cache_path=cache,
            metrics=registry)
        return GNNServeEngine(dyn, params, "gcn", x, g, slots=8,
                              stats=WorkloadStats(window=32), check_every=8,
                              min_records=8, metrics=registry,
                              obs_labels={"replica": i})

    reps = [replica(0), replica(1)]
    cluster = ServeCluster(reps, router=LocalityRouter(), metrics=registry)
    steady = lambda seed: ZipfTraffic(g.num_nodes, d_in, [TrafficPhase(
        requests=100, alpha=1.1, rate=200.0, seeds_max=4)], seed=seed)
    K.reset_launch_counts()
    n_steady = 0
    for rnd in range(20):     # both initial searches close on steady traffic
        if not any(r._tuning for r in reps):
            break
        n_steady += len(cluster.run_trace(steady(20 + rnd)))
    check(not any(r._tuning for r in reps), "an initial search never closed")
    first_configs = [dict(r.config) for r in reps]
    # (b1) a rotation: drift on live traffic, the token staggers retunes
    rotation = list(ZipfTraffic(g.num_nodes, d_in, [
        TrafficPhase(requests=100, alpha=1.1, rate=200.0, seeds_max=4,
                     update_frac=0.02),
        TrafficPhase(requests=250, alpha=1.1, rate=200.0, rotate=True,
                     seeds_max=4, update_frac=0.02)], seed=7))
    res = cluster.run_trace(rotation)
    n_rot = sum(not ev.is_update for ev in rotation)
    rep = cluster.report()
    check(len(res) == n_rot and rep["dropped"] == 0,
          f"rotation: {len(res)} of {n_rot} answered, {rep['dropped']} "
          "dropped")
    check(rep["staggered_retunes"] >= 1, f"no staggered retune: {rep}")
    organic = list(rep["retune_log"])
    for rnd in range(20):     # close any search the rotation left open
        if cluster._token is None and not any(r._tuning for r in reps):
            break
        n_steady += len(cluster.run_trace(steady(60 + rnd)))
    check(cluster._token is None and not any(r._tuning for r in reps),
          "a search never closed after the rotation")
    # (b2) two overlapping drifts: replica 1's signal fires while replica
    # 0 holds the token, so it adopts 0's commit from the shared cache

    def pump():
        for _ in range(400):
            cluster.pump()
            if cluster._token is None:
                return
        fail("a coordinated retune never finished")

    check(reps[0].retune_gate(reps[0], 1.0) is False
          and cluster._token == 0, "replica 0 did not take the token")
    check(reps[1].retune_gate(reps[1], 1.0) is False
          and cluster._token == 0, "replica 1 was not deferred")
    pump()
    first = cluster.retune_log[-1]
    check(first["replica"] == 0 and first["committed"]
          and not first["from_cache"] and first["search_size"] >= 2,
          f"the first retune: {first}")
    check(reps[1].retune_gate(reps[1], 1.0) is False
          and cluster._token == 1, "replica 1 did not take the token")
    pump()
    second = cluster.retune_log[-1]
    check(second["replica"] == 1 and second["committed"]
          and second["from_cache"] and second["search_size"] == 1
          < first["search_size"] and reps[1].config == reps[0].config,
          f"the adoption: {second} after {first}")
    # served == offline after the rejoin, full and cached passes
    for r in reps:
        r.check_every = 10 ** 9
        r.cache.invalidate()        # the first batch takes a full pass
    seeds = [np.array([s]) for s in range(0, 64 * 97, 97)]
    gids = [cluster.submit(s) for s in seeds]
    done = cluster.drain()
    gids += [cluster.submit(s) for s in seeds]
    done += cluster.drain()
    torch.cuda.synchronize()
    launches["cluster_retune"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["cluster_retune"]),
          f"a kernel of the coordinated retune never launched: {counts}")
    by_id = {r.request_id: r for r in done}
    check(sorted(by_id) == sorted(gids), "the probe requests were dropped")
    check({cluster.replica_of(gid) for gid in gids} == {0, 1},
          "the probe requests reached one replica")
    with torch.inference_mode():
        offline = [C.gcn_apply(params, r.eng, r.xp) for r in reps]
    for gid in gids:
        r, i = by_id[gid], cluster.replica_of(gid)
        rows = torch.from_numpy(C.pgas_rows(reps[i].eng.plan, r.seeds)
                                .astype(np.int64)).to(dev)
        check(np.array_equal(r.logits, offline[i][rows].cpu().numpy()),
              f"replica {i}: served != offline after the rejoin")
    check(any(by_id[g].cached for g in gids)
          and not all(by_id[g].cached for g in gids),
          "the probe took no full or no cached pass")
    rep = cluster.report()
    per = rep["per_replica"]
    check(rep["served"] == sum(p["served"] for p in per)
          == registry.counter_total("serve.served")
          == registry.counter_total("cluster.user_served")
          and rep["shadow_served"] == sum(p["shadow_served"] for p in per)
          == registry.counter_total("serve.shadow_served") > 0
          and rep["dropped"] == sum(p["dropped"] for p in per) == 0,
          f"the cluster's counters are not the replicas' sums: {rep}")
    say("cluster_retune", nodes=g.num_nodes, replicas=2,
        spaces=dict(ps=(4, 8, 16), dist=(1, 2), pb=(0, 4)), hw=hw.name,
        first_configs=first_configs, final_configs=[r.config for r in reps],
        steady_requests=n_steady, rotation_requests=n_rot,
        served=rep["served"],
        shadow_served=rep["shadow_served"],
        staggered_retunes=rep["staggered_retunes"],
        deferred_retunes=rep["deferred_retunes"], organic_log=organic,
        adopted_organically=any(e["from_cache"] and e["committed"]
                                for e in organic),
        retune_log=rep["retune_log"],
        search_sizes=[p["search_sizes"] for p in per],
        served_equals_offline="bitwise after the rejoin (full, cached)",
        counters="the cluster's = the replicas' sums = the registry's",
        launches=counts, s=round(time.perf_counter() - t0, 3))


def cluster_launcher():
    """Phase 15 (c): the launcher's cluster, its merged trace validated."""
    from repro_torch.launch import serve_gnn
    from repro_torch.obs import validate

    trace = os.path.join(ROOT, "build", "serve_gnn_cluster_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    rep = serve_gnn.main(["--scale", "1", "--requests", "60", "--rotate",
                          "--devices", "8", "--replicas", "2", "--router",
                          "locality", "--dynamic-tune", "--check-every", "4",
                          "--min-records", "4", "--stats-window", "16",
                          "--feature-capacity", "1536", "--trace", trace])
    check(rep["served"] > 0 and rep["dropped"] == 0
          and rep["device"].startswith("cuda")
          and all(p["served"] > 0 for p in rep["per_replica"]),
          f"the cluster launcher: {rep}")
    problems = validate.validate(trace)
    check(not problems and validate.main([trace]) == 0,
          f"the merged trace: {problems}")
    say("cluster_launcher", served=rep["served"],
        shadow_served=rep["shadow_served"],
        staggered_retunes=rep["staggered_retunes"],
        served_by_replica=[p["served"] for p in rep["per_replica"]],
        p50_ms=rep["p50"] * 1e3, p99_ms=rep["p99"] * 1e3,
        pipeline_profile=rep["pipeline_profile"], trace_valid=True)


# ---------------------------------------------------------------------------
# the baselines (phase 16)
# ---------------------------------------------------------------------------

def _padded_rows(bounds, rows, ids):
    """Global node ids → rows of the padded table ``(n_dev · rows, ·)``."""
    owner = np.searchsorted(bounds, ids, side="right") - 1
    return owner * rows + (ids - bounds[owner])


def baselines(torch, C, K, ops, ref, g, ring, dev, x, part, launches):
    """Phase 16: the bulk and fetch baselines beside the resident ring."""
    from repro_torch.core.pipeline import (bulk_aggregate, bulk_groups,
                                           fetch_groups,
                                           fetch_rows_aggregate,
                                           mgg_aggregate)

    t_phase = time.perf_counter()
    n, d = x.shape
    n_dev = ring.n_dev
    eng = shared_engine(C, g, ring)
    plan, arrays = eng.plan, eng.ring_arrays[0]
    g_full = g.with_self_loops()
    ids = np.arange(n, dtype=np.int64)
    xp = eng.shard(eng.pad(x))
    with torch.inference_mode():
        resident = mgg_aggregate(xp, plan, ring, arrays=arrays)
        resident_ms = _time(torch, lambda: mgg_aggregate(
            xp, plan, ring, arrays=arrays), reps=5)
        scale = mgg_aggregate(xp.abs(), plan, ring, arrays=arrays)
    at = torch.from_numpy(C.pgas_rows(plan, ids).astype(np.int64)).to(dev)
    want, scale = resident[at], scale[at]
    del resident, xp, at
    bounds = plan.bounds
    results = {}

    def held(name, got, rows):
        at = torch.from_numpy(_padded_rows(bounds, rows, ids)).to(dev)
        got = got.reshape(-1, d)[at]
        diff = (got - want).abs()
        check(bool((diff <= 1e-5 * scale + 1e-5).all()),
              f"{name} against the resident ring: {diff.max().item()}")
        return dict(max_abs_err=diff.max().item(),
                    max_err_over_sum_abs=(diff / scale.clamp_min(1e-30))
                    .max().item(),
                    outside_rtol_atol_1e5=int((~torch.isclose(
                        got, want, rtol=1e-5, atol=1e-5)).sum()))

    # bulk: every shard's partitions over the whole (all-gathered) table
    t0 = time.perf_counter()
    nbrs, mask, tgt, rows = C.build_bulk_plan(g_full, n_dev, STREAM_PS,
                                              bounds=bounds)
    groups = bulk_groups(nbrs, mask, tgt, dev)
    build_s = time.perf_counter() - t0
    xb = torch.from_numpy(C.pad_table(bounds, rows, x)).to(dev)
    run = lambda: bulk_aggregate(xb, nbrs, mask, tgt, rows, ring,
                                 groups=groups)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with torch.inference_mode():
        out = run()
    torch.cuda.synchronize()
    launches["bulk_baseline"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["bulk_baseline"]),
          f"a kernel of the bulk baseline never launched: {counts}")
    err = held("bulk", out, rows)
    del out
    with torch.inference_mode():
        for grp in groups:
            _k1_k3_bitwise(torch, ops, ref, xb, grp, rows, "bulk")
        ms = _time(torch, run, reps=5)
    results["bulk"] = dict(
        build_s=round(build_s, 3), ms=ms, launches=counts,
        partitions=sum(grp.num_partitions for grp in groups),
        rows_fetched=n_dev * (n_dev - 1) * rows,
        bytes_fetched=n_dev * (n_dev - 1) * rows * d * 4, **err)
    del groups, nbrs, mask, tgt

    # fetch: each shard's referenced rows (exact, or pages of 16) first
    fetch_counts = {}
    for page in BASELINE_PAGES:
        t0 = time.perf_counter()
        fp = C.build_fetch_plan(g_full, n_dev, STREAM_PS, page_rows=page,
                                bounds=bounds)
        args = (fp["fetch_rows"], fp["nbrs"], fp["mask"], fp["targets"])
        groups = fetch_groups(*args, dev)
        build_s = time.perf_counter() - t0
        check(fp["rows_per_dev"] == rows, "the fetch plan's layout moved")
        run = lambda: fetch_rows_aggregate(xb, *args, rows, groups=groups)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with torch.inference_mode():
            out = run()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check(all(counts[k] > 0 for k in PATH_KERNELS["fetch_baseline"]),
              f"a kernel of the fetch baseline never launched: {counts}")
        for k, v in counts.items():
            fetch_counts[k] = fetch_counts.get(k, 0) + v
        err = held(f"fetch, pages of {page}", out, rows)
        del out
        with torch.inference_mode():
            for fids, grp in groups:
                buf = ops.gather_rows(xb, fids)
                check(torch.equal(buf, ref.gather_rows_ref(xb, fids)),
                      f"fetch {page}: K5 != its plain version")
                _k1_k3_bitwise(torch, ops, ref, buf, grp, rows,
                               f"fetch {page}")
                del buf
            ms = _time(torch, run, reps=5)
        fetched = int(sum(fp["fetched_rows_per_dev"]))
        results[f"fetch_page{page}"] = dict(
            build_s=round(build_s, 3), ms=ms, launches=counts,
            partitions=sum(grp.num_partitions for _, grp in groups),
            rows_fetched=fetched, rows_gathered=int(
                fp["fetch_rows"].size), bytes_fetched=fetched * d * 4,
            **err)
        del groups, fp, args
        torch.cuda.empty_cache()
    launches["fetch_baseline"] = fetch_counts
    say("baselines", nodes=n, d=d, shards=n_dev, ps=STREAM_PS,
        resident=dict(ms=resident_ms, dist=STREAM_DIST,
                      rows_rotated=n_dev * (n_dev - 1) * plan.rows_per_dev,
                      bytes_rotated=n_dev * C.collective_bytes(plan, d)),
        tolerance="|baseline - resident| <= 1e-5 * (A|x|) + 1e-5",
        kernels_bitwise="K1, K3 (and K5) on every group", **results,
        phase_s=round(time.perf_counter() - t_phase, 3))
    del eng, xb, want, scale
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# dense-LM inference (phase 11) and K7
# ---------------------------------------------------------------------------

def _flash_tol(torch, dtype):
    return 2e-5 if dtype == torch.float32 else 1e-2


# bf16 K7 is also held a (b, s, h) row at a time: the rms of the row's
# difference within FLASH_ROW_RTOL of the rms of the plain row.  The flat
# atol of 1e-2 is a third of a typical output on a long causal row (|o| ~
# sqrt(e / keys)); this bound scales with each row.  The kernel's two bf16
# roundings (P before P.V, and the output) are relative and leave well
# under 1 % of a row's rms; a masked key or a dropped 64-key tile moves a
# row by far more.
FLASH_ROW_RTOL = 2e-2


def _flash_held(torch, got, want, dtype, what):
    """K7's output held to its plain version: elementwise within
    :func:`_flash_tol`, and in bf16 every row within ``FLASH_ROW_RTOL`` of
    its own rms.  Returns (largest absolute difference, largest row rms of
    the difference over the row's rms; 0 in fp32)."""
    tol = _flash_tol(torch, dtype)
    g, w = got.float(), want.float()
    check(got.dtype == dtype and got.shape == want.shape
          and torch.allclose(g, w, rtol=tol, atol=tol),
          f"{what}: disagrees with its plain version")
    row = 0.0
    if dtype == torch.bfloat16:
        ratio = ((g - w).pow(2).mean(-1) / w.pow(2).mean(-1)).sqrt()
        row = ratio.max().item()
        check(row <= FLASH_ROW_RTOL, f"{what}: a row's rms difference is "
              f"{row:.4f} of its rms (bound {FLASH_ROW_RTOL})")
    return (g - w).abs().max().item(), row


def sweep_flash(torch, ops, ref, dev, gen):
    """Phase 2's K7 sweep against its plain version, fp32 and bf16: the
    reference's five cases at each head_dim K7 takes, GQA groups 1, 4 and
    12 at S = 50, 1000 and 4096, a window of 16 at S = 1000, mixtral's
    window of 4096 at S = 8192, and causal off (also at whisper's encoder,
    B 1 and 8 x S 1500, H = KV = 8, hd 64).  Returns (cases, the
    largest absolute difference)."""
    shapes = []   # (B, S, H, KV, hd, causal, window)
    for hd in (16, 64, 112, 128):
        shapes += [(b, s, h, kv, hd, c, w)
                   for b, s, h, kv, c, w in FLASH_REF_CASES]
        for s in (50, 1000, 4096):
            shapes += [(1, s, 12, 12, hd, True, 0), (1, s, 8, 2, hd, True, 0),
                       (1, s, 12, 1, hd, True, 0)]
        shapes += [(2, 1000, 4, 2, hd, True, 16),
                   (1, 1000, 4, 1, hd, False, 0)]
    shapes.append((1, 8192, 8, 2, 128, True, 4096))
    # whisper-base's encoder (phase 19): causal off at S 1500, whose last
    # 64-key tile is partial and read by every query row, GQA group 1
    shapes += [(1, 1500, 8, 8, 64, False, 0), (8, 1500, 8, 8, 64, False, 0)]
    worst, worst_row, n = 0.0, 0.0, 0
    for b, s, h, kv, hd, causal, window in shapes:
        q, k, v = (torch.from_numpy(gen.normal(size=(b, s, m, hd)).astype(
            np.float32)).to(dev) for m in (h, kv, kv))
        for dtype in (torch.float32, torch.bfloat16):
            args = (q.to(dtype), k.to(dtype), v.to(dtype))
            want = ref.flash_attention(*args, causal=causal, window=window)
            got = ops.flash_attention(*args, causal=causal, window=window)
            again = ops.flash_attention(*args, causal=causal, window=window)
            what = (f"flash attention B={b} S={s} H={h} KV={kv} hd={hd} "
                    f"causal={causal} window={window} {dtype}")
            err, row = _flash_held(torch, got, want, dtype, what)
            check(torch.equal(got, again), f"{what}: not bitwise stable")
            worst, worst_row = max(worst, err), max(worst_row, row)
            n += 1
    return n, worst, worst_row


def _routing_recorder(moe_lib):
    """Wrap ``moe_lib._route`` (what ``moe_apply`` calls) so that each
    call's expert ids are kept; returns (the record, the restore)."""
    seen, orig = [], moe_lib._route

    def route(p, x2d, cfg):
        gates, tope = orig(p, x2d, cfg)
        seen.append(tope)
        return gates, tope

    moe_lib._route = route

    def restore():
        moe_lib._route = orig
    return seen, restore


def _first_route_difference(a, b):
    """The least flat token index (row-major over B x S) whose expert ids
    differ between two forwards' records, over every layer; None when the
    routing is the same throughout."""
    first = None
    for x, y in zip(a, b):
        diff = (x != y).any(-1).nonzero()
        if diff.numel():
            f = int(diff[0])
            first = f if first is None else min(first, f)
    return first


def _held_prefix(torch, got, want, rtol, n, what):
    """Logits of the first ``n`` flat tokens (all when None) within
    ``rtol`` and ``atol = rtol * max|want|``, a batch row at a time; every
    logit finite.  Returns (the largest absolute difference, tokens
    held)."""
    b, s = got.shape[:2]
    n = b * s if n is None else n
    scale = want.abs().max().item()
    worst = 0.0
    for r in range(b):
        check(torch.isfinite(got[r]).all().item(), f"{what}: not finite")
        m = min(s, max(0, n - r * s))
        if m == 0:
            continue
        a, w = got[r, :m], want[r, :m]
        check(torch.allclose(a, w, rtol=rtol, atol=rtol * scale),
              f"{what}: logits disagree within the first {n} tokens")
        worst = max(worst, (a - w).abs().max().item())
    return worst, n


def lm_forwards(torch, K, params, cfg, toks, n_k7, path, launches,
                bf16=True, keep=None):
    """Phase 18's cache-less forwards of one model: fp32 with
    ``use_flash_attention`` (K7) against the chunked path within rtol 2e-4
    and atol 2e-4 * max|logits|, and with ``bf16`` the configs' bf16
    compute flag on (the main path, launches kept under ``path``) and off,
    each one's rms error against the fp32 logits, the flag-on one's at most
    BF16_RMS_RATIO x the flag-off one's; K7 launched ``n_k7`` times a
    flag-on forward and never with the flag off.  A moe model's routing
    (every layer's expert ids) is recorded in both fp32 forwards: a
    token's routing depends on the tokens before it in the flat B x S
    order only (attention is causal and an expert's slots go by that
    order), so the logits are held up to the first token whose routing
    differs (an fp32 near-tie of two router logits; all tokens when none
    does), and the number of such tokens is reported.  With a ``keep``
    dict, the fp32 flag-on logits stay on the card under
    ``keep["float32_flash"]``."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    b, s = toks.shape
    flag = {dt: {on: dataclasses.replace(cfg, compute_dtype=dt,
                                         use_flash_attention=on)
                 for on in (True, False)} for dt in ("float32", "bfloat16")}

    def forward(c):     # the padded vocab's -1e30 columns left out
        return T.forward(params, c, toks)[0][..., :cfg.vocab]

    counts, routes, out = {}, {}, {}
    with torch.inference_mode():
        logits = {}
        for on in (True, False):
            seen, restore = _routing_recorder(moe_lib)
            try:
                K.reset_launch_counts()
                logits[on] = forward(flag["float32"][on])
                torch.cuda.synchronize()
                c = K.launch_counts()
            finally:
                restore()
            counts[("float32", on)] = c["flash_attention"]
            routes[on] = seen
            if on and not bf16:
                launches[path] = c
        check(logits[True].shape == (b, s, cfg.vocab),
              f"logits of shape {tuple(logits[True].shape)}")
        if keep is not None:
            keep["float32_flash"] = logits[True]
        first = _first_route_difference(routes[True], routes[False])
        n_diff = sum(int((x != y).any(-1).sum())
                     for x, y in zip(routes[True], routes[False]))
        del routes
        err32, held = _held_prefix(torch, logits[True], logits[False], 2e-4,
                                   first, "fp32 forward, flash on against "
                                   "off")
        out.update(fp32_max_abs_err=err32,
                   fp32_max_abs_logit=logits[False].abs().max().item(),
                   fp32_tolerance="rtol 2e-4, atol 2e-4 * max|logits|",
                   fp32_tokens_held=held, fp32_tokens=b * s,
                   fp32_routing_differences=n_diff)
        if bf16:
            ref32 = logits[False].cpu()
            del logits
            logits = {}
            for on in (True, False):
                K.reset_launch_counts()
                logits[on] = forward(flag["bfloat16"][on])
                torch.cuda.synchronize()
                c = K.launch_counts()
                counts[("bfloat16", on)] = c["flash_attention"]
                if on:
                    launches[path] = c
            check(all(torch.isfinite(lg).all().item()
                      for lg in logits.values()), "bf16 logits not finite")
            rms16 = {on: _rms(logits[on], ref32) for on in (True, False)}
            del ref32
            check(rms16[True] <= BF16_RMS_RATIO * rms16[False],
                  f"bf16 forward: K7's rms error against fp32 "
                  f"{rms16[True]} is over {BF16_RMS_RATIO} x the chunked "
                  f"path's {rms16[False]}")
            out.update(
                bf16_rms_err_vs_fp32={"flash": rms16[True],
                                      "chunked": rms16[False]},
                bf16_tolerance=f"flash rms error <= {BF16_RMS_RATIO} x "
                               "chunked",
                bf16_max_abs_diff=max(
                    (x - y).abs().max().item()
                    for x, y in zip(logits[True], logits[False])),
                bf16_same_argmax_share=float(sum(
                    (x.argmax(-1) == y.argmax(-1)).sum().item()
                    for x, y in zip(logits[True], logits[False])) / (b * s)))
        del logits
        dts = ("float32", "bfloat16") if bf16 else ("float32",)
        check(all(counts[(dt, True)] == n_k7 and counts[(dt, False)] == 0
                  for dt in dts),
              f"flash attention launches per forward: {counts} (expected "
              f"{n_k7} with the flag on)")
        timed = (("bfloat16", 3, 1), ("float32", 1, 0)) if bf16 \
            else (("float32", 1, 0),)
        out["forward_ms"] = {f"{dt}_{'flash' if on else 'chunked'}": _time(
            torch, lambda c=flag[dt][on]: forward(c), reps=reps,
            warmup=warmup) for dt, reps, warmup in timed
            for on in (True, False)}
    out["flash_launches_per_forward"] = {
        f"{dt}_{'on' if on else 'off'}": n for (dt, on), n in counts.items()}
    return out, flag


def prefill_decode(torch, params, cfg, toks, prefix, ctx=None):
    """``prefill`` of ``prefix`` tokens then ``decode_step`` against the
    cache-less forward of ``prefix + 1`` tokens (``cfg``'s compute; all
    three under ``ctx``, no mesh by default), within 2e-3; returns the
    two largest differences."""
    from repro_torch.models import transformer as T

    ctx = T.DistCtx() if ctx is None else ctx
    b = toks.shape[0]
    dev = toks.device
    with torch.inference_mode():
        t = toks[:, :prefix + 1]
        full = T.forward(params, cfg, t, ctx=ctx)[0]
        cache = T.init_cache(cfg, b, prefix + 8, dtype=torch.float32,
                             device=dev)
        lg1, cache = T.prefill(params, cfg, t[:, :prefix], cache, ctx=ctx)
        pos = torch.full((b,), prefix, dtype=torch.int32, device=dev)
        lg2, _ = T.decode_step(params, cfg, t[:, prefix], pos, cache,
                               ctx=ctx)
        pairs = ((lg1, full[:, prefix - 1]), (lg2, full[:, prefix]))
        errs = [(x - y).abs().max().item() for x, y in pairs]
        check(all(torch.allclose(x, y, rtol=2e-3, atol=2e-3)
                  for x, y in pairs),
              f"{cfg.name} prefill/decode against the forward: max|diff| "
              f"{errs}")
    return errs


def lm_inference(torch, K, dev, rate, flops, launches):
    """Phase 11: mistral-nemo-12b at full width on one card."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lm
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: fp32 matmuls would keep three digits")
    cfg = configs.get_config(LM_ARCH)
    b, s = LM_B, LM_S
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = T.init_params(gen, cfg, vocab_multiple=16)
    torch.cuda.synchronize()
    from repro_torch.train.tree import tree_leaves
    n_params = sum(t.numel() for t in tree_leaves(params))
    say("lm_built", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, params=n_params,
        param_count=cfg.param_count(), param_dtype=cfg.param_dtype,
        init_s=round(time.perf_counter() - t0, 3),
        gpu_mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3),
        tf32=False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)

    # (a) the cache-less forward with K7 against the chunked path
    kept = {}
    fwd, flag = lm_forwards(torch, K, params, cfg, toks, cfg.n_layers,
                            "lm_forward", launches, keep=kept)
    with torch.inference_mode():
        breakdown = profile_pass(torch, lambda: T.forward(
            params, flag["bfloat16"][True], toks), reps=1)
    say("lm_forward", batch=b, seq=s, **fwd, **breakdown)
    # phase 21 (b)'s live count: the bf16 flag-on forward once under the
    # counter (its time is the one timed above)
    from repro_torch.launch import op_cost
    with torch.inference_mode():
        live = op_cost.analyze(T.forward, params, flag["bfloat16"][True],
                               toks)
    DRY["nemo_forward"] = dict(dot_flops=live.dot_flops,
                               kernels=live.kernels,
                               ms=fwd["forward_ms"]["bfloat16_flash"])
    del live
    k7 = time_flash(torch, K, dev, cfg, rate, flops)

    # (b) prefill of LM_PREFIX tokens, then one decode step, against the
    # cache-less forward of LM_PREFIX + 1 tokens (fp32)
    f32 = flag["float32"][False]
    errs = prefill_decode(torch, params, f32, toks, LM_PREFIX)
    say("lm_prefill_decode", prefix=LM_PREFIX, prefill_max_abs_err=errs[0],
        decode_max_abs_err=errs[1], tolerance="rtol 2e-3 atol 2e-3")

    # one decode step at the launcher's serving shape (4 slots, a 48-slot
    # fp32 cache, bf16 compute), timed and profiled: where a token goes
    bf16 = flag["bfloat16"][False]
    with torch.inference_mode():
        cache = T.init_cache(bf16, 4, 48, dtype=torch.float32, device=dev)
        tok = torch.arange(1, 5, dtype=torch.int32, device=dev)
        pos = torch.full((4,), 20, dtype=torch.int32, device=dev)
        step = lambda: T.decode_step(params, bf16, tok, pos, cache)
        decode_ms = _time(torch, step, reps=10, warmup=2)
        decode_profile = profile_pass(torch, step, reps=3)
        del cache
    say("lm_decode_step", slots=4, cache_slots=48, compute="bfloat16",
        decode_ms=decode_ms, **decode_profile)

    # (d) ring TP over a virtual (data 2, model 4) mesh, held to (a)'s
    # no-mesh fp32 flag-on logits, rms rule and bf16 time
    ring_tp_nemo(torch, K, dev, params, cfg, toks, flag,
                 kept.pop("float32_flash"), fwd, launches)

    # (c) serving: batched == solo in fp32 on these parameters, then the
    # launcher at its defaults with its own (one copy of the weights at a
    # time: these are freed first)
    say("lm_batched_vs_solo", **batched_vs_solo(ServeEngine, params, f32,
                                                LM_BVS_NEW))
    del params
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"{left:.1f} GB still allocated: the weights were "
          "not freed before the launcher draws its own")

    say("lm_served", compute=cfg.compute_dtype,
        **_serve_launcher(serve_lm, LM_ARCH))
    gc.collect()
    torch.cuda.empty_cache()
    return k7


def _serve_launcher(serve_lm, arch):
    """The LM serving launcher at its defaults (8 requests through 4
    slots) but ``LM_SERVE_NEW`` new tokens a request, on the card, every
    request answered; its report."""
    rep = serve_lm.main(["--arch", arch, "--max-new", str(LM_SERVE_NEW)])
    check(rep["device"].startswith("cuda") and rep["requests"] == 8
          and all(r.steps == LM_SERVE_NEW for r in rep["results"]),
          f"the LM serving launcher did not answer every request of {arch} "
          "on the card")
    return dict(arch=rep["arch"], requests=rep["requests"],
                tokens=rep["tokens"], seconds=rep["seconds"],
                tokens_per_s=rep["tokens_per_s"],
                prefill_ms_median=float(np.median(rep["prefill_ms"])),
                prefill_ms=rep["prefill_ms"],
                decode_ms_per_step_median=float(np.median(rep["decode_ms"])),
                decode_steps=len(rep["decode_ms"]))


def batched_vs_solo(ServeEngine, params, cfg, new=32):
    """Phases 11 (c) and 12 (c): the launcher's 8 prompts through 4 slots,
    ``new`` tokens each, batched, against each prompt run alone, in
    ``cfg``'s (fp32) compute.
    Tokens are compared up to the first step whose top-2 logit margin in
    the solo run is under 1e-3 * max|logit|, where the two may rightly
    part.  Logits are compared at every step up to and including the first
    step where the tokens part (after it the two runs feed other inputs),
    all ``new`` when they never part, within rtol LOGIT_TOL and atol
    LOGIT_TOL * max|logit| of the solo run's compared steps: cuBLAS's
    products differ by batch size, so not bitwise."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 17))
               .astype(np.int32) for _ in range(8)]
    eng = ServeEngine(params, cfg, batch_slots=4, max_seq=512)
    batched = eng.generate(prompts, max_new=new, keep_logits=True)
    agree, stops, steps, diffs = [], [], [], []
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new=new, keep_logits=True)[0]
        b_lg, s_lg = batched[i].logits, solo.logits
        check(len(solo.tokens) == new and len(batched[i].tokens) == new
              and b_lg.shape == s_lg.shape == (new, s_lg.shape[1]),
              f"request {i}: not {new} tokens and their logits")
        top2 = np.partition(s_lg, -2, axis=-1)[:, -2:]
        margins = (np.abs(top2[:, 1] - top2[:, 0])
                   / np.abs(s_lg).max(axis=-1))
        n = next((j for j, m in enumerate(margins) if m < 1e-3), new)
        if n < new:
            stops.append(dict(request=i, step=n, margin=float(margins[n])))
        check(batched[i].tokens[:n] == solo.tokens[:n],
              f"request {i}: batched tokens differ from solo before step {n}")
        agree.append(n)
        part = next((j for j in range(new)
                     if batched[i].tokens[j] != solo.tokens[j]), new - 1)
        scale = float(np.abs(s_lg[:part + 1]).max())
        diff = float(np.abs(b_lg[:part + 1] - s_lg[:part + 1]).max())
        check(np.allclose(b_lg[:part + 1], s_lg[:part + 1], rtol=LOGIT_TOL,
                          atol=LOGIT_TOL * scale),
              f"request {i}: batched logits differ from solo by {diff} "
              f"(max|logit| {scale}) within the first {part + 1} steps")
        steps.append(part + 1)
        diffs.append(diff)
    return dict(requests=len(prompts), compute=cfg.compute_dtype,
                tokens_compared=agree, stopped_at_small_margin=stops,
                margin_rule="top-2 margin < 1e-3 * max|logit|",
                logit_steps_compared=steps, logit_max_abs_diff=diffs,
                logit_tolerance=f"rtol {LOGIT_TOL}, atol {LOGIT_TOL} * "
                                "max|logit|")


def time_flash(torch, K, dev, cfg, rate, flops, b=LM_B, s=LM_S,
               causal=True):
    """K7 at one layer's shapes of a B x S forward of ``cfg`` (phase 11
    (a)'s by default): q (B, S, H, hd), k/v (B, S, KV, hd), ``causal`` (a
    decoder) or not (whisper's encoder), the config's window, in bf16 (the
    configs' compute dtype) and fp32, held to its plain version, beside
    the plain version and ``scaled_dot_product_attention`` (timed only,
    never on the path; none where the window bites, which it cannot
    express without a mask)."""
    import torch.nn.functional as F

    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = cfg.sliding_window or 0
    g = torch.Generator(device=dev).manual_seed(1)
    base = [torch.randn((b, s, n, hd), generator=g, device=dev)
            for n in (h, kv, kv)]
    # the (query, key) pairs kept: causal, within the window
    pairs = K.cost.attention_pairs(s, causal, w)
    out = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            got = K.flash_attention.flash_attention(q, k, v, causal=causal,
                                                    window=w)
            want = K.ref.flash_attention(q, k, v, causal=causal, window=w)
            err, row = _flash_held(torch, got, want, dtype,
                                   f"flash_attention at the LM's shapes "
                                   f"({dtype})")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            t_plain = _time(torch, lambda: K.ref.flash_attention(
                q, k, v, causal=causal, window=w), reps=2, warmup=1)
            t_k7 = _time(torch, lambda: K.flash_attention.flash_attention(
                q, k, v, causal=causal, window=w), reps=10, warmup=2)
            t_lib = None if w and w < s else _time(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), reps=10,
                warmup=2)
            name = str(dtype).replace("torch.", "")
            n_flops, nbytes, _ = K.cost.flash_attention(
                b, s, h, kv, hd, causal=causal, window=w,
                itemsize=q.element_size())
            t_flops = n_flops / flops[name] * 1e3
            t_bytes = nbytes / rate * 1e3
            out[name] = dict(
                ms=t_k7, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=max(t_flops, t_bytes),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                max_abs_err=err, max_row_rms_ratio=row, flops=n_flops,
                bytes=nbytes,
                peak_flops=flops[name])
            del got, want, q, k, v, qt, kt, vt
    main = out["bfloat16"]
    return dict(name="flash_attention", route="cuda",
                source=SOURCE["flash_attention"],
                replaces=REPLACES["flash_attention"],
                max_abs_err=main["max_abs_err"],
                max_row_rms_ratio=main["max_row_rms_ratio"], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                library=f"scaled_dot_product_attention(is_causal={causal}, "
                        "enable_gqa)",
                dtype="bfloat16", float32=out["float32"],
                shape=dict(batch=b, seq=s, heads=h, kv_heads=kv, head_dim=hd,
                           causal=causal, window=w),
                flops=main["flops"], bytes=main["bytes"], kept_pairs=pairs)

# ---------------------------------------------------------------------------
# xlstm inference (phase 12) and K8
# ---------------------------------------------------------------------------

def _slstm_case(torch, gen, b, s, h, hd, dev):
    """xp (B, S, H·4·hd) ~ N(0, 1), wr ~ N(0, 1/hd) as the model draws it,
    and a random non-trivial state: h, c and m of either sign, n in
    [0.5, 2)."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    shape = (b, h, hd)
    return (t(gen.normal(size=(b, s, h * 4 * hd))),
            t(gen.normal(size=(h, hd, 4 * hd)) * hd ** -0.5),
            dict(h=t(gen.normal(size=shape) * 0.5),
                 c=t(gen.normal(size=shape)),
                 n=t(gen.uniform(0.5, 2.0, shape)),
                 m=t(gen.normal(size=shape))))


def _slstm_held(torch, got, want, what):
    """K8's (hs, states) within SLSTM_TOL of its plain version's; returns
    the largest absolute difference."""
    pairs = [(got[0], want[0])] + [(got[1][k], want[1][k]) for k in "hcnm"]
    check(all(a.shape == b.shape and torch.allclose(
        a, b, rtol=SLSTM_TOL, atol=SLSTM_TOL) for a, b in pairs),
        f"{what}: disagrees with its plain version")
    return max((a - b).abs().max().item() for a, b in pairs)


def _slstm_same(torch, a, b):
    return torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k])
                                           for k in "hcnm")


def sweep_slstm(torch, ops, ref, K, dev, gen):
    """Phase 2's K8 sweep against its plain version: hd 8/16/64/192, H
    1/2/4, B 1/3/8, S 1/7/256/4096, each from a random state; and the
    three bitwise invariants on every case: two launches equal, the last
    row alone equal to it in its batch (and the batch at bt 1 equal to bt
    8), one launch over S equal to two with the state carried.  Returns
    (cases, the largest absolute difference)."""
    worst, n = 0.0, 0
    hds, hs_, bs, ss = SLSTM_SWEEP
    for hd in hds:
        for h in hs_:
            for b in bs:
                for s in ss:
                    xp, wr, st = _slstm_case(torch, gen, b, s, h, hd, dev)
                    what = f"sLSTM scan B={b} S={s} H={h} hd={hd}"
                    got = ops.slstm_scan(xp, wr, st)
                    worst = max(worst, _slstm_held(
                        torch, got, ref.slstm_scan_ref(xp, wr, st), what))
                    check(_slstm_same(torch, got, ops.slstm_scan(xp, wr, st)),
                          f"{what}: two launches differ")
                    k8 = K.slstm_scan.slstm_scan
                    i = b - 1
                    solo = k8(xp[i:i + 1].contiguous(), wr,
                              {k: v[i:i + 1].contiguous()
                               for k, v in st.items()})
                    check(_slstm_same(torch, solo, (
                        got[0][i:i + 1],
                        {k: v[i:i + 1] for k, v in got[1].items()})),
                        f"{what}: a row alone differs from it in its batch")
                    check(_slstm_same(torch, k8(xp, wr, st, bt=1), got),
                          f"{what}: bt 1 differs from bt 8")
                    if s > 1:
                        cut = s // 3 or 1
                        h1, st1 = k8(xp[:, :cut].contiguous(), wr, st)
                        h2, st2 = k8(xp[:, cut:].contiguous(), wr, st1)
                        check(_slstm_same(torch, (torch.cat([h1, h2], 1),
                                                  st2), got),
                              f"{what}: split at {cut} differs")
                    n += 1
                    del xp, wr, st, got
    return n, worst


def xlstm_inference(torch, K, dev, rate, flops, launches):
    """Phase 12: xlstm-125m at full width on one card."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lm
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    from repro_torch.train.tree import tree_leaves

    cfg = configs.get_config(XL_ARCH)
    b, s = XL_B, XL_S
    pat = cfg.xlstm_pattern
    n_slstm = cfg.n_layers // len(pat) * pat.count("s")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = T.init_params(gen, cfg, vocab_multiple=16)
    torch.cuda.synchronize()
    say("xlstm_built", arch=cfg.name, layers=cfg.n_layers, pattern=pat,
        d_model=cfg.d_model, heads=cfg.n_heads, mlstm_d_in=2 * cfg.d_model,
        mlstm_dk=2 * cfg.d_model // cfg.n_heads,
        slstm_hd=cfg.d_model // cfg.n_heads, vocab=cfg.vocab,
        ssm_chunk=cfg.ssm_chunk,
        params=sum(t.numel() for t in tree_leaves(params)),
        param_dtype=cfg.param_dtype, init_s=round(time.perf_counter() - t0, 3),
        gpu_mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    cfgs = {dt: dataclasses.replace(cfg, compute_dtype=dt)
            for dt in ("bfloat16", "float32")}

    def forward(c, t=toks):
        return T.forward(params, c, t)[0]

    # (a) the cache-less forward: bf16 (the configs' compute) is the main
    # path; the fp32 one records every K8 call's inputs and outputs
    calls = []
    plain_scan = ops.slstm_scan

    def recording(xp, wr, st):
        out = plain_scan(xp, wr, st)
        calls.append((xp, wr, {k: v.clone() for k, v in st.items()}, out))
        return out

    with torch.inference_mode():
        K.reset_launch_counts()
        lg16 = forward(cfgs["bfloat16"])
        torch.cuda.synchronize()
        launches["xlstm_forward"] = K.launch_counts()
        ops.slstm_scan = recording
        try:
            lg32 = forward(cfgs["float32"])
        finally:
            ops.slstm_scan = plain_scan
        torch.cuda.synchronize()
        n16 = launches["xlstm_forward"]["slstm_scan"]
        check(n16 == n_slstm and len(calls) == n_slstm,
              f"K8 launches a forward: {n16} (bf16), {len(calls)} (fp32); "
              f"expected {n_slstm}")
        for lg in (lg16, lg32):
            check(lg.shape == (b, s, cfg.vocab) and all(
                torch.isfinite(r).all().item() for r in lg),
                f"xlstm logits of shape {tuple(lg.shape)} or not finite")
        diff16 = max((x.float() - y).abs().max().item()
                     for x, y in zip(lg16, lg32))
        same_argmax = float(sum((x.argmax(-1) == y.argmax(-1)).sum().item()
                                for x, y in zip(lg16, lg32)) / (b * s))
        max32 = lg32.abs().max().item()
        del lg16, lg32
        errs = [_slstm_held(torch, out, K.ref.slstm_scan_ref(xp, wr, st),
                            f"K8 on sLSTM layer {i} of the fp32 forward")
                for i, (xp, wr, st, out) in enumerate(calls)]
        fwd_ms = {dt: _time(torch, lambda c=cfgs[dt]: forward(c), reps=reps,
                            warmup=1)
                  for dt, reps in (("bfloat16", 3), ("float32", 2))}
        breakdown = profile_pass(torch, lambda: forward(cfgs["bfloat16"]),
                                 reps=1)
    say("xlstm_forward", batch=b, seq=s, slstm_launches_per_forward=n16,
        k8_max_abs_err_by_layer=errs, k8_tolerance=f"rtol {SLSTM_TOL} atol "
        f"{SLSTM_TOL}", bf16_vs_fp32_max_abs_diff=diff16,
        fp32_max_abs_logit=max32, bf16_fp32_same_argmax_share=same_argmax,
        forward_ms=fwd_ms, **breakdown)
    xp, wr, st, _ = calls[0]
    k8 = time_slstm(torch, K, xp, wr, st, rate, flops)
    k8["max_abs_err"] = max(errs)
    del calls, xp, wr, st

    # (b) prefill of XL_PREFIX tokens, then one decode step, against the
    # cache-less forward of XL_PREFIX + 1 tokens (fp32)
    f32 = cfgs["float32"]
    with torch.inference_mode():
        t = toks[:, :XL_PREFIX + 1]
        full = forward(f32, t)
        cache = T.init_cache(f32, b, XL_PREFIX + 8, dtype=torch.float32,
                             device=dev)
        lg1, cache = T.prefill(params, f32, t[:, :XL_PREFIX], cache)
        pos = torch.full((b,), XL_PREFIX, dtype=torch.int32, device=dev)
        K.reset_launch_counts()
        lg2, _ = T.decode_step(params, f32, t[:, XL_PREFIX], pos, cache)
        torch.cuda.synchronize()
        per_step = K.launch_counts()["slstm_scan"]
        check(per_step == n_slstm,
              f"K8 launches a decode step: {per_step}, expected {n_slstm}")
        pairs = ((lg1, full[:, XL_PREFIX - 1]), (lg2, full[:, XL_PREFIX]))
        errs = [(x - y).abs().max().item() for x, y in pairs]
        check(all(torch.allclose(x, y, rtol=2e-3, atol=2e-3)
                  for x, y in pairs),
              f"xlstm prefill/decode against the forward: max|diff| {errs}")
        del full, cache, lg1, lg2
    say("xlstm_prefill_decode", prefix=XL_PREFIX, prefill_max_abs_err=errs[0],
        decode_max_abs_err=errs[1], tolerance="rtol 2e-3 atol 2e-3",
        slstm_launches_per_decode_step=per_step)

    # one decode step at the launcher's serving shape (4 slots, bf16)
    bf16 = cfgs["bfloat16"]
    with torch.inference_mode():
        cache = T.init_cache(bf16, 4, 48, dtype=torch.float32, device=dev)
        tok = torch.arange(1, 5, dtype=torch.int32, device=dev)
        pos = torch.full((4,), 20, dtype=torch.int32, device=dev)
        step = lambda: T.decode_step(params, bf16, tok, pos, cache)
        decode_ms = _time(torch, step, reps=10, warmup=2)
        decode_profile = profile_pass(torch, step, reps=3)
        del cache
    say("xlstm_decode_step", slots=4, compute="bfloat16",
        decode_ms=decode_ms, **decode_profile)

    # (c) serving: batched == solo in fp32 on these parameters, then the
    # launcher at its defaults with its own
    say("xlstm_batched_vs_solo", **batched_vs_solo(ServeEngine, params, f32))
    del params
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    served = _serve_launcher(serve_lm, XL_ARCH)
    torch.cuda.synchronize()
    launches["xlstm_serving"] = K.launch_counts()
    n_serve = launches["xlstm_serving"]["slstm_scan"]
    check(n_serve == n_slstm * (len(served["prefill_ms"])
                                + served["decode_steps"]),
          f"K8 launches while serving: {n_serve}")
    say("xlstm_served", slstm_launches=n_serve, compute=cfg.compute_dtype,
        **served)
    gc.collect()
    torch.cuda.empty_cache()
    return k8


def time_slstm(torch, K, xp, wr, st, rate, flops):
    """K8 at phase 12 (a)'s shapes (one sLSTM layer of the B x S forward:
    xp (B, S, H·4·hd), wr (H, hd, 4·hd)), beside its plain version.  No
    PyTorch call computes this recurrence (``nn.LSTM`` is the classic LSTM:
    a sigmoid input gate, no normaliser n, no stabiliser m), so there is
    no library time.  Bound: the recurrent products' 2·B·S·H·hd·4·hd flops
    over the fp32 peak, or xp, hs, wr and the states read or written once
    over the memory rate, whichever is larger.  Also: the plan's cluster
    size and shared memory a block; every portable cluster size that fits
    timed in turns (and held bitwise to the plan's result), and µs a step
    at every size that fits for hd 32 to 256 (S 1024, B 2 and B 8); the
    cluster probe a step at each size, K8's exchange of h alone (st.async
    and mbarriers: the floor of a step); and a decode-shape launch (B 4,
    S 1, 100 launches) by CUDA events and by the profiler's device time."""
    k8m = K.slstm_scan
    b, s = xp.shape[0], xp.shape[1]
    h, hd = wr.shape[0], wr.shape[1]
    bt = min(k8m.MAX_BT, b)
    cluster, smem = k8m.plan(hd, bt)
    sizes = k8m.cluster_sizes(hd, bt)
    with torch.inference_mode():
        k8 = lambda: k8m.slstm_scan(xp, wr, st)
        t_k8 = _time(torch, k8, reps=5, warmup=1)
        want = k8()
        for c in sizes:
            check(_slstm_same(torch, k8m._launch(xp, wr, st, bt, c), want),
                  f"K8 at {c} blocks a cluster differs from the plan's "
                  f"{cluster}")
        by_c = {c: [] for c in sizes}
        for order in (sizes, sizes[::-1]):          # in turns: a b b a
            for c in order:
                by_c[c].append(_time(
                    torch, lambda c=c: k8m._launch(xp, wr, st, bt, c),
                    reps=3, warmup=1))
        probe_ms = {}
        for c in sizes:
            run = lambda c=c: k8m.cluster_probe(b, s, h, hd, bt, c,
                                                xp.device)
            check(bool((run() == s).all().item()),
                  f"the cluster probe at {c} blocks lost a store")
            probe_ms[c] = _time(torch, run, reps=5, warmup=1)
        rng = np.random.default_rng(1)
        by_hd = {}                   # the plan's rule: S 1024, H 4
        for b_r in (2, 8):
            for hd_r in (32, 64, 128, 192, 256):
                xr, wr_r, sr = _slstm_case(torch, rng, b_r, 1024, 4, hd_r,
                                           xp.device)
                by_hd.setdefault(str(b_r), {})[str(hd_r)] = dict(
                    plan=k8m.plan(hd_r, b_r)[0], **{
                        str(c): _time(torch, lambda c=c: k8m._launch(
                            xr, wr_r, sr, b_r, c), reps=3, warmup=1)
                        * 1e3 / 1024
                        for c in k8m.cluster_sizes(hd_r, b_r)})
                del xr, wr_r, sr
        xd, wd, sd = _slstm_case(torch, rng, 4, 1, h, hd, xp.device)
        decode = lambda: k8m.slstm_scan(xd, wd, sd)
        decode_ms = _time(torch, decode, reps=100, warmup=5)
        decode_dev = profile_pass(torch, decode, reps=100)
        t_plain = _time(torch, lambda: K.ref.slstm_scan_ref(xp, wr, st),
                        reps=1, warmup=0)
    n_flops, nbytes, _ = K.cost.slstm_scan(b, s, h, hd)
    t_flops = n_flops / flops["float32"] * 1e3
    t_bytes = nbytes / rate * 1e3
    return dict(name="slstm_scan", route="cuda", source=SOURCE["slstm_scan"],
                replaces=REPLACES["slstm_scan"], ms=t_k8, plain_ms=t_plain,
                bound_ms=max(t_flops, t_bytes),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                library_ms=None,
                library="none: nn.LSTM/cuDNN compute the classic LSTM (no "
                        "normaliser n, no stabiliser m)",
                dtype="float32", shape=dict(batch=b, seq=s, heads=h,
                                            head_dim=hd),
                flops=n_flops, bytes=nbytes, peak_flops=flops["float32"],
                cluster=cluster, smem_bytes_per_block=smem,
                us_per_step=t_k8 * 1e3 / s,
                ms_by_cluster={str(c): v for c, v in by_c.items()},
                us_per_step_by_batch_and_head_dim=by_hd,
                probe_us_per_step={str(c): v * 1e3 / s
                                   for c, v in probe_ms.items()},
                decode_shape=dict(batch=4, seq=1, reps=100),
                decode_shape_ms=decode_ms,
                decode_shape_device_ms=sum(
                    v for k, v in decode_dev["device_ms_by_kernel"].items()
                    if "slstm" in k),
                decode_shape_cluster=k8m.plan(hd, 4)[0])


# ---------------------------------------------------------------------------
# K9 (phase 2) and LM training (phase 17)
# ---------------------------------------------------------------------------

def _k9_held(torch, got, want, what):
    """K9's gradients (a list of tensors, None where there is none) within
    rtol K9_TOL and atol K9_TOL x max|want| of the plain version's; returns
    the largest absolute difference and the largest difference over the
    tensor's max |.|."""
    err, rel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None:
            continue
        scale = b.abs().max().item() or 1.0
        check(a.shape == b.shape and torch.allclose(
            a, b, rtol=K9_TOL, atol=K9_TOL * scale),
            f"{what}: gradient {i} disagrees with the plain version "
            f"(max|diff| {(a - b).abs().max().item():.3g}, max|.| "
            f"{scale:.3g})")
        d = (a - b).abs().max().item()
        err, rel = max(err, d), max(rel, d / scale)
    return err, rel


def _rms_ratio(torch, a, b):
    """rms(a - b) / rms(b)."""
    return ((a - b).double().pow(2).mean().sqrt()
            / b.double().pow(2).mean().sqrt().clamp_min(1e-30)).item()


def _k9_inputs(torch, gen, b, s, h, hd, dev):
    """A K8 case (``_slstm_case``) and random gradients of hs and of the
    final states."""
    xp, wr, st = _slstm_case(torch, gen, b, s, h, hd, dev)
    dhs = torch.from_numpy(gen.normal(size=(b, s, h, hd)).astype(
        np.float32)).to(dev)
    dst = {k: torch.from_numpy(gen.normal(size=(b, h, hd)).astype(
        np.float32)).to(dev) for k in "hcnm"}
    return xp, wr, st, dhs, dst


def _kernel_grads(torch, ops, xp, wr, st, dhs, dst):
    """The gradients through ``ops.slstm_scan`` on the card (K8 with its
    save, K9, the dwr matmul): [dxp, dwr, dh0, dc0, dn0, dm0]."""
    x, w = xp.clone().requires_grad_(), wr.clone().requires_grad_()
    s0 = {k: v.clone().requires_grad_() for k, v in st.items()}
    with torch.enable_grad():
        hs, new = ops.slstm_scan(x, w, s0)
        return list(torch.autograd.grad(
            [hs] + [new[k] for k in "hcnm"], [x, w] + [s0[k] for k in "hcnm"],
            [dhs] + [dst[k] for k in "hcnm"]))


def _plain_grads(ref, xp, wr, st, dhs, dst):
    dxp, dwr, d0 = ref.slstm_scan_grad_ref(xp, wr, st, dhs, dst)
    return [dxp, dwr] + [d0[k] for k in "hcnm"]


def sweep_slstm_backward(torch, ops, ref, K, dev, gen):
    """Phase 2's K9 sweep: hd 8/16/64/192/256, H 1/2/4, B 1/3/8, S 1/7/256,
    each from a random state with random gradients of hs and of the final
    states.  K8's save leaves hs and the states bitwise and holds the
    plain loop's gates and states within SLSTM_TOL; K9 (through
    ``ops.slstm_scan`` under autograd) within K9_TOL of the plain
    version; and K9's bitwise invariants: two launches equal, a row alone
    equal to it in its batch, bt 1 and bt 8 equal to the plan's rows
    (``bwd_rows``), one launch over S equal
    to the launch over the last steps then the one over the first with
    the gradients carried.  Returns (cases, the largest absolute
    difference, the largest difference over the tensor's max |.|)."""
    k9m = K.slstm_scan
    worst, rel, n = 0.0, 0.0, 0
    hds, hs_, bs, ss = SLSTM_BWD_SWEEP
    for hd in hds:
        for h in hs_:
            for b in bs:
                for s in ss:
                    xp, wr, st, dhs, dst = _k9_inputs(torch, gen, b, s, h, hd,
                                                      dev)
                    what = f"sLSTM backward B={b} S={s} H={h} hd={hd}"
                    hs, new, saved = k9m.slstm_scan(xp, wr, st, save=True)
                    check(_slstm_same(torch, (hs, new),
                                      k9m.slstm_scan(xp, wr, st)),
                          f"{what}: K8 with its save differs from K8")
                    plain = ref.slstm_scan_save_ref(xp, wr, st)
                    check(all(torch.allclose(saved[k], plain[k],
                                             rtol=SLSTM_TOL, atol=SLSTM_TOL)
                              for k in "gcnm"),
                          f"{what}: K8's saved gates or states disagree "
                          "with the plain loop's")
                    e, r = _k9_held(
                        torch, _kernel_grads(torch, ops, xp, wr, st, dhs, dst),
                        _plain_grads(ref, xp, wr, st, dhs, dst), what)
                    worst, rel = max(worst, e), max(rel, r)
                    whole = k9m.slstm_scan_backward(dhs, dst, wr, saved, st)
                    same = lambda a, c: torch.equal(a[0], c[0]) and all(
                        torch.equal(a[1][k], c[1][k]) for k in "hcnm")
                    check(same(whole, k9m.slstm_scan_backward(
                        dhs, dst, wr, saved, st)),
                        f"{what}: two launches differ")
                    for bt in (1, 8):
                        check(same(whole, k9m.slstm_scan_backward(
                            dhs, dst, wr, saved, st, bt=bt)),
                            f"{what}: bt {bt} differs from the plan's rows")
                    i = b - 1
                    row = lambda d: {k: v[i:i + 1].contiguous()
                                     for k, v in d.items()}
                    solo = k9m.slstm_scan_backward(
                        dhs[i:i + 1].contiguous(), row(dst), wr, row(saved),
                        row(st))
                    check(same(solo, (whole[0][i:i + 1], row(whole[1]))),
                          f"{what}: a row alone differs from it in its batch")
                    if s > 1:
                        cut = s // 3 or 1
                        part = lambda d, sl: {k: v[:, sl].contiguous()
                                              for k, v in d.items()}
                        mid = {k: saved[k][:, cut - 1].contiguous()
                               for k in "cnm"}
                        dx2, carried = k9m.slstm_scan_backward(
                            dhs[:, cut:].contiguous(), dst, wr,
                            part(saved, slice(cut, None)), mid)
                        dx1, d0 = k9m.slstm_scan_backward(
                            dhs[:, :cut].contiguous(), carried, wr,
                            part(saved, slice(None, cut)), st)
                        check(same((torch.cat([dx1, dx2], 1), d0), whole),
                              f"{what}: split at {cut} differs")
                    n += 1
                    del xp, wr, st, dhs, dst, saved, plain, whole
    return n, worst, rel


def _peak_gb(torch):
    return round(torch.cuda.max_memory_allocated() / 1e9, 3)


def _to_dev(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def lm_training(torch, K, dev, rate, flops, launches):
    """Phase 17: LM training at full width on one card (xlstm-125m, then
    one step of mistral-nemo-12b cut to 2 layers); returns K9's kernels
    entry."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as ltrain
    from repro_torch.launch import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.train import (AdamWConfig, LMDataConfig, Trainer,
                                   TrainState, adamw_init, lm_batch,
                                   make_loss_fn, make_train_step)
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.trainer import _grads_of
    from repro_torch.train.tree import tree_flatten_with_names, tree_leaves
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(TRAIN_ARCH)
    pat = cfg.xlstm_pattern
    n_slstm = cfg.n_layers // len(pat) * pat.count("s")

    # (a) the launcher at its defaults (seq 256, batch 8, remat on, bf16)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rep = ltrain.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_LM_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["lm_training"] = K.launch_counts()
    got = launches["lm_training"]
    want = {"slstm_scan": 2 * n_slstm * TRAIN_LM_STEPS,
            "slstm_scan_backward": n_slstm * TRAIN_LM_STEPS}
    check(all(got[k] == v for k, v in want.items()),
          f"K8/K9 launches over {TRAIN_LM_STEPS} steps: {got}, expected "
          f"{want} (remat: K8 twice an sLSTM layer a step)")
    losses = rep["losses"]
    check(rep["device"].startswith("cuda") and len(losses) == TRAIN_LM_STEPS
          and all(np.isfinite(losses)), "the launcher did not train")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"the loss did not fall: first 5 {first:.4f}, last "
                        f"5 {last:.4f}")
    say("lm_training_launcher", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads,
        slstm_hd=cfg.d_model // cfg.n_heads, vocab=cfg.vocab,
        compute=cfg.compute_dtype, param_dtype=cfg.param_dtype,
        remat=cfg.remat, seq=256, batch=8, steps=TRAIN_LM_STEPS,
        launches={k: got[k] for k in want},
        launches_per_step={k: got[k] / TRAIN_LM_STEPS for k in want},
        loss_first5_mean=first, loss_last5_mean=last, losses=losses,
        step_ms=rep["step_ms"],
        step_ms_median=float(np.median(rep["step_ms"][1:])),
        peak_gb=_peak_gb(torch), wall_s=round(wall, 3))
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    # (b) step 0's gradients: K8/K9 against the plain loop under autograd,
    # on the card, in fp32 compute (the comparison measures the kernels,
    # not bf16 rounding) and without remat (one K8 an sLSTM layer)
    f32 = dataclasses.replace(cfg, compute_dtype="float32", remat=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, f32, vocab_multiple=16)
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=256, global_batch=8, doc_len=256), 0), dev)
    loss_fn = make_loss_fn(f32, T.DistCtx())
    fwd_in, bwd = [], []
    plain_scan, orig_bwd = ops.slstm_scan, ops._SLSTMScan.backward

    def recording_scan(xp, wr, st):
        fwd_in.append((xp.detach(), wr.detach(),
                       {k: v.detach().clone() for k, v in st.items()}))
        return plain_scan(xp, wr, st)

    def recording_bwd(ctx, *grads):
        out = orig_bwd(ctx, *grads)
        bwd.append(([g.detach().clone() for g in grads],
                    [None if o is None else o.detach() for o in out[:6]]))
        return out

    ops.slstm_scan = recording_scan
    ops._SLSTMScan.backward = staticmethod(recording_bwd)
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_loss, _, k_grads = _grads_of(loss_fn, params, batch)
        torch.cuda.synchronize()
        kernel_ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
    finally:
        ops.slstm_scan = plain_scan
        ops._SLSTMScan.backward = staticmethod(orig_bwd)
    check(counts["slstm_scan"] == n_slstm and counts["slstm_scan_backward"]
          == n_slstm and len(fwd_in) == len(bwd) == n_slstm,
          f"step 0 on the kernels: {counts}, {len(fwd_in)} forward and "
          f"{len(bwd)} backward calls recorded")
    ops.slstm_scan = lambda xp, wr, st: ref.slstm_scan_ref(xp, wr, st)
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_loss, _, p_grads = _grads_of(loss_fn, params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(not any(K.launch_counts().values()),
              "the plain step launched a kernel")
    finally:
        ops.slstm_scan = plain_scan
    check(torch.allclose(k_loss, p_loss, rtol=TRAIN_GRAD_TOL,
                         atol=TRAIN_GRAD_TOL),
          f"step 0's loss: {k_loss.item()} (kernels) against "
          f"{p_loss.item()} (plain)")
    leaf_err = {}
    for (name, a), b in zip(tree_flatten_with_names(k_grads),
                            tree_leaves(p_grads)):
        scale = b.abs().max().item() or 1.0
        leaf_err[name] = (a - b).abs().max().item() / scale
        check(torch.allclose(a, b, rtol=TRAIN_GRAD_TOL,
                             atol=TRAIN_GRAD_TOL * scale),
              f"step 0's gradient {name}: kernels against plain, max|diff| "
              f"{leaf_err[name] * scale:.3g}, max|.| {scale:.3g}")
    # K9 against its plain version on every sLSTM layer's inputs of that
    # step (the backward runs the layers in reverse)
    k9_err, k9_rel = 0.0, 0.0
    for i, (xp, wr, st) in enumerate(fwd_in):
        grads, out = bwd[n_slstm - 1 - i]
        dst = dict(zip("hcnm", grads[1:]))
        want = _plain_grads(ref, xp, wr, st, grads[0], dst)
        e, r = _k9_held(torch, out, want, f"K9 on sLSTM layer {i} of step 0")
        k9_err, k9_rel = max(k9_err, e), max(k9_rel, r)
    say("lm_training_gradients", compute="float32", remat=False, seq=256,
        batch=8, loss_kernels=k_loss.item(), loss_plain=p_loss.item(),
        step_grad_ms_kernels=kernel_ms, step_grad_ms_plain=plain_ms,
        tolerance=f"rtol {TRAIN_GRAD_TOL}, atol {TRAIN_GRAD_TOL} x "
                  "max|leaf|", max_err_over_max_by_leaf=leaf_err,
        k9_layers=len(fwd_in), k9_max_abs_err=k9_err,
        k9_max_err_over_max=k9_rel,
        k9_tolerance=f"rtol {K9_TOL}, atol {K9_TOL} x max|.|")
    del params, batch, k_grads, p_grads, fwd_in, bwd
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a step at train_4k's length (B x S = 2 x 4096), the launcher's
    # configuration: timed (CUDA events and the host clock) and profiled
    b4, s4 = TRAIN_4K_B, TRAIN_4K_S
    c4 = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, s4))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, c4, vocab_multiple=16)
    opt = adamw_init(params)
    # phase 21 (d) holds the dry run's argument bytes to these
    DRY["xlstm_train_state_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves((params, opt)))
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=s4, global_batch=b4, doc_len=s4), 0), dev)
    step = make_train_step(c4, T.DistCtx(), AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=TRAIN_LM_STEPS))
    run = lambda: step(params, opt, batch)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    loss4 = run()[2]["loss"].item()
    torch.cuda.synchronize()
    counts4 = K.launch_counts()
    peak4 = _peak_gb(torch)
    check(np.isfinite(loss4) and counts4["slstm_scan"] == 2 * n_slstm
          and counts4["slstm_scan_backward"] == n_slstm,
          f"the 2 x 4096 step: loss {loss4}, launches {counts4}")
    step4_ms = _time(torch, run, reps=2, warmup=0)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step4_host_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_step(torch, run)
    del opt
    parts = time_step_parts(torch, c4, params, batch, dev)
    say("lm_training_4k", batch=b4, seq=s4, compute=c4.compute_dtype,
        remat=c4.remat, loss=loss4, step_ms=step4_ms,
        step_ms_host=step4_host_ms, peak_gb=peak4,
        launches_per_step={k: counts4[k] for k in PATH_KERNELS[
            "lm_training"]}, **prof, parts_ms=parts)
    del params, batch, run, step
    gc.collect()
    torch.cuda.empty_cache()
    k9 = time_slstm_backward(torch, K, ops, ref, dev, rate, flops)
    k9["max_abs_err"] = k9_err
    k9["max_err_over_max"] = k9_rel

    # (d) the trainer's guarantees, at full width, seq 128, batch 2
    dsmall = LMDataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2,
                          doc_len=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, vocab_multiple=16)
    step = make_train_step(cfg, T.DistCtx(), AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=12))
    calls = dict(n=0)

    def flaky(p, o, bt):
        calls["n"] += 1
        if calls["n"] == 9:                   # step 8
            raise RuntimeError("injected failure at step 8")
        return step(p, o, bt)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    try:
        tr = Trainer(flaky, ltrain.lm_batches(cfg, dsmall, dev),
                     TrainState(params, adamw_init(params)), workdir=workdir,
                     ckpt_every=5, log_fn=lambda *_: None)
        restart_losses = tr.run(12)
        latest = ck.latest_step(workdir)
        check(tr.state.step == 12 and tr.restarts == 1 and latest == 10
              and len(restart_losses) == 15,
              f"the injected failure: step {tr.state.step}, restarts "
              f"{tr.restarts}, latest checkpoint {latest}, "
              f"{len(restart_losses)} losses")
        del tr
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def traced_run(**obs):
        tr = Trainer(step, ltrain.lm_batches(cfg, dsmall, dev),
                     TrainState(params, adamw_init(params)),
                     log_fn=lambda *_: None, **obs)
        return tr.run(5)

    base = traced_run()
    tracer, reg = Tracer(), MetricsRegistry()
    traced = traced_run(tracer=tracer, metrics=reg)
    check(base == traced, f"traced losses {traced} differ from {base}")
    n_spans = sum(e["name"] == "train.step" for e in tracer.events())
    check(n_spans == 5, f"{n_spans} train.step spans")
    # accumulation in fp32 compute, as the reference's test: with bf16
    # products a microbatch's gradient differs from its share of the full
    # batch's by bf16 rounding, which flips the first AdamW step's sign
    # where a gradient is near 0
    big = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=256, global_batch=8, doc_len=256), 0), dev)
    accum = {a: make_train_step(f32, T.DistCtx(), AdamWConfig(lr=1e-3),
                                accum_steps=a)(params, adamw_init(params),
                                               big)[0] for a in (1, 4)}
    diffs = [(a - b).abs().max().item() for a, b in zip(
        tree_leaves(accum[1]), tree_leaves(accum[4]))]
    check(all(torch.allclose(a, b, rtol=2e-4, atol=2e-5) for a, b in zip(
        tree_leaves(accum[1]), tree_leaves(accum[4]))),
        f"accum 4 against 1: max|diff| {max(diffs):.3g}")
    say("lm_training_trainer", restart=dict(
            steps=12, injected_at=8, ckpt_every=5, restarts=1,
            latest_checkpoint=10, losses=restart_losses),
        tracing_bitwise=True, traced_losses=traced, train_step_spans=n_spans,
        accum4_vs_1_max_abs_diff=max(diffs),
        accum_tolerance="rtol 2e-4, atol 2e-5 (the reference's test)",
        seq=128, batch=2, accum_seq=256, accum_batch=8,
        accum_compute="float32")
    del params, accum, big
    gc.collect()
    torch.cuda.empty_cache()

    # (e) examples/train_lm.py's port with --tune-accum
    rep = train_lm.main(["--tune-accum", "--steps", "24"])
    say("lm_training_tune_accum", steps=24, seq=128, batch=4,
        converged=rep["converged"], accum=rep["accum"],
        measured=rep["measured"], step_fn_swaps=rep["retunes"],
        why_not=None if rep["converged"] else
        f"{rep['measured']} measurements of a window of 3 steps each did "
        "not close the search within 24 steps",
        losses=rep["losses"], step_ms=rep["step_ms"])
    check(all(np.isfinite(rep["losses"])), "train_lm's losses not finite")
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the dense family: one AdamW step of mistral-nemo-12b at full
    # width, its depth cut to DENSE_TRAIN_LAYERS, B 1, S 4096, bf16 compute
    dcfg = dataclasses.replace(configs.get_config(DENSE_TRAIN_ARCH),
                               n_layers=DENSE_TRAIN_LAYERS)
    check(not dcfg.use_flash_attention, "flash attention on for training")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, dcfg, vocab_multiple=16)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=dcfg.vocab, seq_len=4096, global_batch=1, doc_len=4096), 0),
        dev)
    step = make_train_step(dcfg, T.DistCtx(), AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=TRAIN_LM_STEPS))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(params, adamw_init(params), batch)
    loss = out[2]["loss"].item()
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(loss), f"mistral-nemo-12b step loss {loss}")
    check(not any(K.launch_counts().values()),
          f"a kernel ran in the dense step: {K.launch_counts()}")
    say("lm_training_dense", arch=dcfg.name,
        cut=f"depth {DENSE_TRAIN_LAYERS} of "
            f"{configs.get_config(DENSE_TRAIN_ARCH).n_layers} layers, full "
            "width", params=n_params, d_model=dcfg.d_model, d_ff=dcfg.d_ff,
        vocab=dcfg.vocab, batch=1, seq=4096, compute=dcfg.compute_dtype,
        flash=False, remat=dcfg.remat, loss=loss,
        step_ms_host_first_call=dense_ms, peak_gb=_peak_gb(torch))
    del params, batch, out, step
    gc.collect()
    torch.cuda.empty_cache()
    return k9


def profile_step(torch, fn):
    """One call of ``fn`` under torch.profiler: device ms by kind (K8, K9,
    matrix products, the rest) and the ten largest kernels, beside the
    profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms(prof)

    def kind(name):
        low = name.lower()
        if "slstm_bwd" in low:
            return "K9 slstm_scan_backward"
        if "slstm_cluster" in low:
            return "K8 slstm_scan"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90_")):
            return "matrix products"
        return "other (elementwise, reductions, copies)"

    by_kind = {}
    for k, v in by_kernel.items():
        by_kind[kind(k)] = by_kind.get(kind(k), 0.0) + v
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    busy = sum(by_kernel.values())
    return dict(profiled_wall_ms=wall_ms, device_ms_sum=busy,
                device_idle_share=max(0.0, 1 - busy / wall_ms),
                device_ms_by_kind=by_kind, device_ms_top=dict(top))


def time_step_parts(torch, cfg, params, batch, dev):
    """CUDA-event times of the parts of the 2 x 4096 step at its shapes:
    one sLSTM layer's dwr product, one mLSTM mixer and one sLSTM mixer
    forward and backward (bf16 compute, as the step), and the head (the
    tied unembedding and the cross-entropy) forward and backward."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.layers import unembed_logits
    from repro_torch.train.tree import tree_map

    b, s = batch["tokens"].shape
    heads, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    g = np.random.default_rng(2)
    h_prev = torch.from_numpy(g.normal(size=(b, s, heads, hd)).astype(
        np.float32)).to(dev)
    dxp = torch.from_numpy(g.normal(size=(b, s, heads, 4 * hd)).astype(
        np.float32)).to(dev)
    out = dict(dwr_matmul_ms=_time(torch, lambda: torch.einsum(
        "bshk,bshg->hkg", h_prev, dxp), reps=5, warmup=1))
    del h_prev, dxp
    x = torch.from_numpy(g.normal(size=(b, s, cfg.d_model)).astype(
        np.float32)).to(dev).to(cfg.cdtype)
    for name, fn in (("mlstm", X.mlstm_apply), ("slstm", X.slstm_apply)):
        key = "xl_0_m" if name == "mlstm" else "xl_1_s"
        p = tree_map(lambda t: t[0].detach().requires_grad_(),
                     params[key]["mix"])
        xin = x.detach().requires_grad_()

        def fb(p=p, xin=xin, fn=fn):
            with torch.enable_grad():
                y, _ = fn(p, xin, cfg)
                y.float().sum().backward()

        out[f"{name}_layer_fwd_bwd_ms"] = _time(torch, fb, reps=2, warmup=1)
    emb = params["embed"]["w"].detach().requires_grad_()
    tok = batch["tokens"]

    def head():
        with torch.enable_grad():
            logits = unembed_logits({"w": emb}, x, cfg.vocab)
            logp = torch.log_softmax(logits[:, :-1], -1)
            ll = torch.gather(logp, -1, tok[:, 1:, None].long())
            (-ll.mean()).backward()

    out["head_fwd_bwd_ms"] = _time(torch, head, reps=2, warmup=1)
    return out


def time_slstm_backward(torch, K, ops, ref, dev, rate, flops):
    """K9 at phase 17 (c)'s shapes (one sLSTM layer of the B x S = 2 x 4096
    step: dhs (B, S, H, hd), the saved gates (B, S, H, hd, 4) and states),
    beside its plain version (autograd through the plain loop: the forward
    and the backward, as the plain path runs them), held by K9_RMS_TOL.  No
    PyTorch call computes this backward, so there is no library time.
    Bound: the step-to-step products' 2·B·S·H·hd·4·hd flops over the fp32
    peak, or dhs, the saved gates and states, wr and the states read once
    and dxp and the initial states' gradients written once over the memory
    rate, whichever is larger.  Also the plan's rows and blocks a cluster,
    shared memory a block and where wr's rows sit, µs a step, every cluster
    size that fits timed in turns and held bitwise to the plan's, K9's
    exchange alone (the backward cluster probe: a float4 a unit a row to
    every block, the floor of a step) at each size, and K9 at the
    launcher's shape (B 8, S 256)."""
    k9m = K.slstm_scan
    gen = np.random.default_rng(17)
    b, s, h, hd = TRAIN_4K_B, TRAIN_4K_S, 4, 192
    xp, wr, st, dhs, dst = _k9_inputs(torch, gen, b, s, h, hd, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bt = k9m.bwd_rows(b, h, sms)
    cluster, smem = k9m.plan(hd, bt, backward=True)
    sizes = k9m.cluster_sizes(hd, bt, backward=True)
    with torch.inference_mode():
        _, _, saved = k9m.slstm_scan(xp, wr, st, save=True)
        k9 = lambda: k9m.slstm_scan_backward(dhs, dst, wr, saved, st)
        t_k9 = _time(torch, k9, reps=5, warmup=1)
        want = k9()
        by_c = {c: [] for c in sizes}
        for order in (sizes, sizes[::-1]):
            for c in order:
                got = k9m._launch_backward(dhs, dst, wr, saved, st, bt, c)
                check(torch.equal(got[0], want[0]) and all(
                    torch.equal(got[1][k], want[1][k]) for k in "hcnm"),
                    f"K9 at {c} blocks a cluster differs from the plan's "
                    f"{cluster}")
                by_c[c].append(_time(torch, lambda c=c: k9m._launch_backward(
                    dhs, dst, wr, saved, st, bt, c), reps=3, warmup=1))
        probe_ms = {}
        for c in sizes:
            run = lambda c=c: k9m.cluster_probe(b, s, h, hd, bt, c, dev,
                                                backward=True)
            check(bool((run() == s).all().item()),
                  f"K9's exchange probe at {c} blocks lost a store")
            probe_ms[c] = _time(torch, run, reps=5, warmup=1)
        xl, wl, sl, dl, tl = _k9_inputs(torch, gen, 8, 256, h, hd, dev)
        _, _, savl = k9m.slstm_scan(xl, wl, sl, save=True)
        t_launcher = _time(torch, lambda: k9m.slstm_scan_backward(
            dl, tl, wl, savl, sl), reps=20, warmup=2)
        del xl, wl, sl, dl, tl, savl
    kern = _kernel_grads(torch, ops, xp, wr, st, dhs, dst)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = _plain_grads(ref, xp, wr, st, dhs, dst)
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t0) * 1e3
    rms = [_rms_ratio(torch, a, c) for a, c in zip(kern, plain)]
    check(max(rms) <= K9_RMS_TOL,
          f"K9 at S = {s}: rms differences over rms {rms} above {K9_RMS_TOL}")
    n_flops, nbytes, _ = K.cost.slstm_scan_backward(b, s, h, hd)
    t_flops = n_flops / flops["float32"] * 1e3
    t_bytes = nbytes / rate * 1e3
    return dict(name="slstm_scan_backward", route="cuda",
                source=SOURCE["slstm_scan_backward"],
                replaces=REPLACES["slstm_scan_backward"], ms=t_k9,
                plain_ms=t_plain, plain="autograd through the plain loop "
                                        "(its forward and backward)",
                bound_ms=max(t_flops, t_bytes),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                library_ms=None,
                library="none: no PyTorch call computes the sLSTM's "
                        "backward (nn.LSTM/cuDNN is the classic LSTM)",
                dtype="float32", shape=dict(batch=b, seq=s, heads=h,
                                            head_dim=hd),
                flops=n_flops, bytes=nbytes, peak_flops=flops["float32"],
                cluster=cluster, rows_per_cluster=bt,
                smem_bytes_per_block=smem,
                wr_in_registers=k9m.bwd_wr_in_registers(hd, cluster),
                us_per_step=t_k9 * 1e3 / s,
                ms_by_cluster={str(c): v for c, v in by_c.items()},
                exchange_probe_ms=probe_ms[cluster],
                exchange_probe_us_per_step=probe_ms[cluster] * 1e3 / s,
                exchange_probe_ms_by_cluster={str(c): v
                                              for c, v in probe_ms.items()},
                launcher_shape=dict(batch=8, seq=256, heads=h, head_dim=hd,
                                    rows_per_cluster=k9m.bwd_rows(8, h, sms)),
                launcher_shape_ms=t_launcher,
                launcher_shape_us_per_step=t_launcher * 1e3 / 256,
                rms_diff_over_rms_at_4096=rms,
                rms_tolerance=K9_RMS_TOL)


# ---------------------------------------------------------------------------
# the moe and hybrid families at full width (phase 18) and K7 on them
# ---------------------------------------------------------------------------

def _kinds(name, *extra):
    """A kernel's kind for phase 18's profiles: K7, the ``extra`` (kind,
    name fragments) pairs in order, matrix products, the rest."""
    low = name.lower()
    if "flash" in low:
        return "K7 flash_attention"
    for kind, frags in extra:
        if any(f in low for f in frags):
            return kind
    if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90_")):
        return "matrix products"
    return "other (elementwise, reductions, copies)"


def profile_kinds(torch, fn, kind):
    """One call of ``fn`` (after one unprofiled) under torch.profiler:
    device ms by kind (``kind(kernel name)``) and the ten largest kernels,
    beside the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms(prof)
    by_kind = {}
    for k, v in by_kernel.items():
        by_kind[kind(k)] = by_kind.get(kind(k), 0.0) + v
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_wall_ms=wall_ms, device_ms_sum=busy,
                idle_share=1 - busy / wall_ms, device_ms_by_kind=by_kind,
                device_ms_by_kernel=dict(top))


def time_moe_parts(torch, T, moe_lib, params, cfg, toks):
    """CUDA-event times of one moe layer's parts on layer 0's inputs
    (``cfg``'s compute): the attention block (projections and K7), the
    routing (router product, sort, softmax), the dispatch maps (argsorts,
    searchsorted), the dispatch gather, the expert FFN (three batched
    products), the combine (gather and gate-weighted sum) and the whole
    ``moe_apply``."""
    from repro_torch.models.layers import embed_lookup
    from repro_torch.train.tree import tree_map

    ctx = T.DistCtx()
    b, s = toks.shape
    e, k = cfg.n_experts, cfg.top_k
    with torch.inference_mode():
        bp = tree_map(lambda x: x[0], params["blocks"])
        h = embed_lookup(params["embed"], toks, cfg.cdtype)
        pos = torch.arange(s, dtype=torch.int32,
                           device=toks.device).expand(b, s)
        attn = lambda: T._attn_sub(bp, h, cfg, pos, None, ctx)
        z = T._norm(attn()[0], bp["ln2"], cfg)
        p, x2d = bp["moe"], z.reshape(b * s, -1)
        cap = max(1, int(b * s * k / e * cfg.moe_capacity_factor))
        gates, tope = moe_lib._route(p, x2d, cfg)
        slot_token, slot_valid, pair_slot, pair_kept = \
            moe_lib._dispatch_indices(tope, e, cap)
        pair_idx = tope * cap + pair_slot.clamp(0, cap - 1)
        disp = lambda: moe_lib._Dispatch.apply(x2d, slot_token, slot_valid,
                                               pair_idx, pair_kept)
        xe = disp()
        ye = moe_lib._expert_ffn(p, xe, cfg)
        w = (gates * pair_kept).to(x2d.dtype)

        def combine():
            y = ye.reshape(e * cap, -1)[pair_idx.reshape(-1)]
            return torch.einsum("tkd,tk->td", y.reshape(b * s, k, -1), w)

        run = lambda fn: _time(torch, fn, reps=5, warmup=1)
        return dict(
            compute=cfg.compute_dtype, tokens=b * s, capacity=cap,
            dispatch_buffer=list(xe.shape),
            dropped_pairs=int((~pair_kept).sum()), pairs=b * s * k,
            attention_block_ms=run(attn),
            route_ms=run(lambda: moe_lib._route(p, x2d, cfg)),
            dispatch_indices_ms=run(
                lambda: moe_lib._dispatch_indices(tope, e, cap)),
            dispatch_gather_ms=run(disp),
            expert_ffn_ms=run(lambda: moe_lib._expert_ffn(p, xe, cfg)),
            combine_ms=run(combine),
            moe_apply_ms=run(lambda: moe_lib.moe_apply(p, z, cfg)))


def time_mamba_parts(torch, T, params, cfg, toks):
    """CUDA-event times of one mamba block's parts on layer 0's inputs
    (``cfg``'s compute): the in-projection, the causal conv, the whole
    ``ssm_apply`` (its chunk loop is the rest), the gated norm and
    out-projection; and one application of the shared attention block."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_lookup, rms_norm
    from repro_torch.train.tree import tree_map

    b, s = toks.shape
    d_in = cfg.d_model * cfg.ssm_expand
    with torch.inference_mode():
        bp = tree_map(lambda x: x[0], params["mamba_main"])
        h = embed_lookup(params["embed"], toks, cfg.cdtype)
        pos = torch.arange(s, dtype=torch.int32,
                           device=toks.device).expand(b, s)
        z = T._norm(h, bp["ln"], cfg)
        p = bp["ssm"]
        zz, xbc, _ = ssm._split_proj(p, z, cfg)
        y = torch.randn((b, s, d_in), device=toks.device).to(cfg.cdtype)
        run = lambda fn: _time(torch, fn, reps=3, warmup=1)
        out = dict(
            compute=cfg.compute_dtype, chunk=min(cfg.ssm_chunk, s),
            in_proj_ms=run(lambda: ssm._split_proj(p, z, cfg)),
            conv_ms=run(lambda: ssm._causal_conv(xbc, p["conv_w"], None)),
            out_norm_proj_ms=run(lambda: rms_norm(
                y * F.silu(zz), p["norm_w"], cfg.norm_eps)
                @ p["out_proj"]["w"].to(cfg.cdtype)),
            ssm_apply_ms=run(lambda: ssm.ssm_apply(p, z, cfg)),
            shared_block_ms=run(lambda: T._dense_block(
                params["shared_attn"], h, cfg, pos, None, T.DistCtx())))
    out["chunk_loop_ms"] = out["ssm_apply_ms"] - out["in_proj_ms"] \
        - out["conv_ms"] - out["out_norm_proj_ms"]
    return out


def _grads_twice(torch, _grads_of, loss_fn, params, batch, what):
    """One step's loss and gradients computed twice from the same state:
    bitwise equal, every leaf finite.  Returns (the loss, leaves)."""
    from repro_torch.train.tree import tree_leaves

    runs = [_grads_of(loss_fn, params, batch) for _ in range(2)]
    a, b = (tree_leaves(r[2]) for r in runs)
    check(torch.equal(runs[0][0], runs[1][0])
          and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{what}: a step's loss and gradients differ between two runs")
    bad = [i for i, g in enumerate(a) if not torch.isfinite(g).all().item()]
    check(not bad, f"{what}: {len(bad)} gradient leaves not finite")
    return float(runs[0][0]), len(a)


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def moe_hybrid(torch, K, dev, rate, flops, launches):
    """Phase 18: granite-moe-1b-a400m and zamba2-7b served and trained at
    full width, mixtral-8x7b at full width with its depth cut; returns
    K7's entries at (a)'s and (b)'s layer shapes."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import train as ltrain
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    from repro_torch.train import (AdamWConfig, LMDataConfig, adamw_init,
                                   lm_batch, make_loss_fn, make_train_step)
    from repro_torch.train.trainer import _grads_of
    from repro_torch.train.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    b, s = P18_B, P18_S
    k7 = {}

    def draw(cfg, train=False):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode(not train):
            params = T.init_params(gen, cfg, vocab_multiple=16)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        return params, dict(params=n, param_count=cfg.param_count(),
                            init_s=round(time.perf_counter() - t0, 3),
                            gpu_mem_gb=round(
                                torch.cuda.memory_allocated() / 1e9, 3))

    def tokens(cfg, bb, ss, seed=0):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            1, cfg.vocab, (bb, ss)).astype(np.int32)).to(dev)

    moe_kind = lambda n: _kinds(
        n, ("routing and sort", ("sort", "radix", "search", "softmax")),
        ("dispatch and combine gathers", ("index", "gather", "scatter")))

    # (a) granite-moe-1b-a400m as published
    cfg = configs.get_config(MOE_ARCH)
    params, built = draw(cfg)
    say("moe_built", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff=cfg.d_ff, vocab=cfg.vocab, capacity_factor=cfg.
        moe_capacity_factor, **built)
    toks = tokens(cfg, b, s)
    fwd, flag = lm_forwards(torch, K, params, cfg, toks, cfg.n_layers,
                            "moe_forward", launches)
    with torch.inference_mode():
        prof = profile_kinds(torch, lambda: T.forward(
            params, flag["bfloat16"][True], toks), moe_kind)
    parts = time_moe_parts(torch, T, moe_lib, params, flag["bfloat16"][True],
                           toks)
    say("moe_forward", arch=cfg.name, batch=b, seq=s, **fwd, **prof,
        layer_parts=parts)
    no_drop = dataclasses.replace(flag["float32"][False],
                                  moe_capacity_factor=float(cfg.n_experts))
    errs = prefill_decode(torch, params, no_drop, toks, P18_PREFIX)
    say("moe_prefill_decode", prefix=P18_PREFIX, capacity="no-drop",
        prefill_max_abs_err=errs[0], decode_max_abs_err=errs[1],
        tolerance="rtol 2e-3 atol 2e-3")
    del params, toks
    _free(torch)
    say("moe_served", **_serve_launcher(serve_lm, MOE_ARCH))
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = ltrain.main(["--arch", MOE_ARCH, "--steps", str(MOE_TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    losses = rep["losses"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(rep["device"].startswith("cuda") and len(losses) == MOE_TRAIN_STEPS
          and all(np.isfinite(losses)) and last < first,
          f"{MOE_ARCH} did not train: first 5 {first}, last 5 {last}")
    peak = _peak_gb(torch)
    tcfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, 256))
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=256, global_batch=8, doc_len=256),
        MOE_TRAIN_STEPS), dev)
    loss, n_leaves = _grads_twice(torch, _grads_of,
                                  make_loss_fn(tcfg, T.DistCtx()),
                                  rep["state"].params, batch, MOE_ARCH)
    say("moe_training", arch=cfg.name, seq=256, batch=8, remat=cfg.remat,
        compute=cfg.compute_dtype, steps=MOE_TRAIN_STEPS, losses=losses,
        loss_first5_mean=first, loss_last5_mean=last,
        step_ms=rep["step_ms"],
        step_ms_median=float(np.median(rep["step_ms"][1:])), peak_gb=peak,
        wall_s=round(wall, 3), repeated_step_loss=loss,
        repeated_step="loss and every gradient leaf bitwise equal",
        gradient_leaves=n_leaves)
    k7["at_granite"] = time_flash(torch, K, dev, cfg, rate, flops, b, s)
    del rep, batch
    _free(torch)

    # (b) zamba2-7b as published
    cfg = configs.get_config(HYB_ARCH)
    n_groups = cfg.n_layers // cfg.attn_every
    params, built = draw(cfg)
    say("hybrid_built", arch=cfg.name, layers=cfg.n_layers,
        groups=n_groups, group_size=cfg.attn_every,
        tail=cfg.n_layers - n_groups * cfg.attn_every, d_model=cfg.d_model,
        ssm_heads=cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim,
        ssm_headdim=cfg.ssm_headdim, ssm_state=cfg.ssm_state,
        ssm_chunk=cfg.ssm_chunk, attn_heads=cfg.n_heads,
        head_dim=cfg.head_dim, window=cfg.sliding_window, d_ff=cfg.d_ff,
        vocab=cfg.vocab, **built)
    toks = tokens(cfg, b, s)
    fwd, flag = lm_forwards(torch, K, params, cfg, toks, n_groups,
                            "hybrid_forward", launches)
    with torch.inference_mode():
        prof = profile_kinds(torch, lambda: T.forward(
            params, flag["bfloat16"][True], toks), lambda n: _kinds(n))
    parts = time_mamba_parts(torch, T, params, flag["bfloat16"][True], toks)
    say("hybrid_forward", arch=cfg.name, batch=b, seq=s, **fwd, **prof,
        layer_parts=parts)
    f32 = flag["float32"][False]
    errs = prefill_decode(torch, params, f32, toks, P18_PREFIX)
    say("hybrid_prefill_decode", prefix=P18_PREFIX,
        prefill_max_abs_err=errs[0], decode_max_abs_err=errs[1],
        tolerance="rtol 2e-3 atol 2e-3",
        forward_513="one chunk of 513 (the reference's rule)")
    del toks
    say("hybrid_batched_vs_solo", **batched_vs_solo(ServeEngine, params,
                                                    f32, LM_BVS_NEW))
    del params
    _free(torch)
    say("hybrid_served", **_serve_launcher(serve_lm, HYB_ARCH))
    _free(torch)
    # training: AdamW's state for 6.6 B parameters does not fit one card,
    # so the depth is cut to 2 groups and a tail of 1, at full width
    cut = dataclasses.replace(cfg, n_layers=HYB_TRAIN_LAYERS)
    tcut = dataclasses.replace(cut, ssm_chunk=min(cut.ssm_chunk, 256))
    params, built = draw(tcut, train=True)
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=256, global_batch=8, doc_len=256), 0), dev)
    loss0, n_leaves = _grads_twice(torch, _grads_of,
                                   make_loss_fn(tcut, T.DistCtx()), params,
                                   batch, f"{HYB_ARCH} cut, step 0")
    del params, batch
    _free(torch)
    orig = configs.get_config
    configs.get_config = lambda arch: cut if arch == HYB_ARCH \
        else orig(arch)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        rep = ltrain.main(["--arch", HYB_ARCH, "--steps",
                           str(HYB_TRAIN_STEPS)])
        wall = time.perf_counter() - t0
    finally:
        configs.get_config = orig
    losses = rep["losses"]
    check(rep["device"].startswith("cuda") and len(losses) == HYB_TRAIN_STEPS
          and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"{HYB_ARCH} (cut) did not train: {losses}")
    say("hybrid_training", arch=cfg.name,
        cut=f"depth {HYB_TRAIN_LAYERS} of {cfg.n_layers} layers (2 groups "
            "of 6 and a tail of 1), full width", params=built["params"],
        seq=256, batch=8, ssm_chunk=tcut.ssm_chunk, remat=cut.remat,
        compute=cut.compute_dtype, step0_loss=loss0,
        step0_gradients=f"{n_leaves} leaves, every one finite, bitwise "
                        "equal across two runs",
        steps=HYB_TRAIN_STEPS, losses=losses, step_ms=rep["step_ms"],
        step_ms_median=float(np.median(rep["step_ms"][1:])),
        peak_gb=_peak_gb(torch), wall_s=round(wall, 3))
    k7["at_zamba2"] = time_flash(torch, K, dev, cfg, rate, flops, b, s)
    del rep
    _free(torch)

    # (c) mixtral-8x7b at full width, its depth cut
    full = configs.get_config(MIX_ARCH)
    cfg = dataclasses.replace(full, n_layers=MIX_LAYERS)
    params, built = draw(cfg)
    toks = tokens(cfg, b, s)
    fwd, _ = lm_forwards(torch, K, params, cfg, toks, cfg.n_layers,
                         "mixtral_forward", launches, bf16=False)
    say("mixtral_forward", arch=cfg.name,
        cut=f"depth {MIX_LAYERS} of {full.n_layers} layers, full width",
        batch=b, seq=s, experts=cfg.n_experts, top_k=cfg.top_k,
        window=cfg.sliding_window, **built, **fwd)
    del params, toks
    _free(torch)
    # AdamW's step holds the parameters, gradients, m and v and their new
    # copies (7 x 12.66 GB at 2 layers, over the card's 80 GB), so the
    # step's depth is cut further
    step_cfg = dataclasses.replace(full, n_layers=MIX_TRAIN_LAYERS)
    params, built = draw(step_cfg, train=True)
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=full.vocab, seq_len=4096, global_batch=1, doc_len=4096), 0),
        dev)
    step = make_train_step(step_cfg, T.DistCtx(), AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=TRAIN_LM_STEPS))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(params, adamw_init(params), batch)
    loss = out[2]["loss"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(loss), f"{MIX_ARCH} step loss {loss}")
    say("mixtral_training", arch=full.name,
        cut=f"depth {MIX_TRAIN_LAYERS} of {full.n_layers} layers, full "
            "width", params=built["params"], batch=1, seq=4096,
        compute=step_cfg.compute_dtype, flash=False, loss=loss,
        step_ms_host_first_call=step_ms, peak_gb=_peak_gb(torch))
    del params, batch, out, step
    _free(torch)
    say("phase18", wall_s=round(time.perf_counter() - t_phase, 3))
    return {at: {k: v for k, v in e.items()
                 if k not in ("name", "route", "source", "replaces")}
            for at, e in k7.items()}


# ---------------------------------------------------------------------------
# whisper-base, the encdec family (phase 19)
# ---------------------------------------------------------------------------

def _k7_recorder(ops):
    """Wrap ``ops.flash_attention`` (what the model calls) so that each
    call's inputs, flags and output are kept; returns (the record, the
    restore)."""
    calls, orig = [], ops.flash_attention

    def rec(q, k, v, *, causal=True, window=0):
        out = orig(q, k, v, causal=causal, window=window)
        calls.append((q, k, v, causal, window, out))
        return out

    ops.flash_attention = rec

    def restore():
        ops.flash_attention = orig
    return calls, restore


def _rms(a, b):
    """The rms of ``a - b`` in fp32, a batch row at a time (``b``'s rows
    moved to ``a``'s device)."""
    return math.sqrt(sum((x.float() - y.to(x.device).float()).pow(2).sum()
                         .item() for x, y in zip(a, b)) / a.numel())


def whisper(torch, K, dev, rate, flops, launches):
    """Phase 19: whisper-base encoded, decoded and trained at full width;
    returns K7's entry at the encoder's shape (``at_whisper``)."""
    from repro_torch import configs
    from repro_torch.configs.whisper_base import N_FRAMES
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec as E
    from repro_torch.models.transformer import DistCtx
    from repro_torch.train import (AdamWConfig, LMDataConfig, Trainer,
                                   TrainState, adamw_init, lm_batch,
                                   make_loss_fn, make_train_step)
    from repro_torch.train.trainer import _grads_of
    from repro_torch.train.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = configs.get_config(W_ARCH)
    n_enc, n_dec, v = cfg.n_enc_layers, cfg.n_layers, cfg.vocab
    b, t, s = W_B, N_FRAMES, W_TOKENS
    flag = {(dt, on): dataclasses.replace(cfg, compute_dtype=dt,
                                          use_flash_attention=on)
            for dt in ("float32", "bfloat16") for on in (True, False)}

    def draw(train=False):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode(not train):
            params = E.init_params(gen, cfg, vocab_multiple=16)
        torch.cuda.synchronize()
        return params, dict(
            params=sum(x.numel() for x in tree_leaves(params)),
            init_s=round(time.perf_counter() - t0, 3),
            gpu_mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    def frames(bb, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((bb, t, cfg.d_model), generator=g, device=dev)

    def tokens(bb, ss, step):
        return torch.from_numpy(lm_batch(LMDataConfig(
            vocab=v, seq_len=ss, global_batch=bb, doc_len=ss), step)[
            "tokens"]).to(dev)

    def ar(bb, n):
        return torch.arange(n, dtype=torch.int32, device=dev).expand(bb, n)

    def forward(c, p, fr, tk):   # the padded vocab's -1e30 columns left out
        enc = E.encode(p, c, fr)
        logits, _ = E._decoder(p, c, tk, enc, ar(fr.shape[0], t),
                               ctx=DistCtx(), positions=ar(*tk.shape))
        return enc, logits[..., :v]

    params, built = draw()
    say("whisper_built", arch=cfg.name, enc_layers=n_enc, dec_layers=n_dec,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=v,
        padded_vocab=params["embed"]["w"].shape[0], frames=t, **built)
    fr, tk = frames(b, 0), tokens(b, s, 0)

    # (a) the forward, flag on and off
    with torch.inference_mode():
        calls, restore = _k7_recorder(ops)
        try:
            K.reset_launch_counts()
            enc16, lg16 = forward(flag[("bfloat16", True)], params, fr, tk)
            torch.cuda.synchronize()
            launches["whisper_forward"] = K.launch_counts()
        finally:
            restore()
        n_k7 = launches["whisper_forward"]["flash_attention"]
        check(n_k7 == n_enc + n_dec
              and [c[3] for c in calls] == [False] * n_enc + [True] * n_dec,
              f"whisper's flag-on forward launched K7 {n_k7} times, causal "
              f"{[c[3] for c in calls]} (expected {n_enc} off, {n_dec} on)")
        held_err, held_row = 0.0, 0.0
        for i, (q, k, vv, causal, window, out) in enumerate(calls):
            err, row = _flash_held(
                torch, out, ref.flash_attention(q, k, vv, causal=causal,
                                                window=window),
                q.dtype, f"whisper forward, K7 call {i} (causal {causal})")
            held_err, held_row = max(held_err, err), max(held_row, row)
        del calls
        # the twins: the same flag-on forwards with K7's plain version
        plain = {}
        ops.flash_attention = ref.flash_attention
        try:
            K.reset_launch_counts()
            for dt in ("float32", "bfloat16"):
                plain[dt] = forward(flag[(dt, True)], params, fr, tk)[1]
            torch.cuda.synchronize()
            check(K.launch_counts()["flash_attention"] == 0,
                  "the plain twin launched K7")
        finally:
            restore()
        K.reset_launch_counts()
        lg32 = forward(flag[("float32", True)], params, fr, tk)[1]
        check(K.launch_counts()["flash_attention"] == n_enc + n_dec,
              "the fp32 flag-on forward did not launch K7 12 times")
        check(lg32.shape == (b, s, v) and enc16.shape == (b, t, cfg.d_model),
              f"logits of shape {tuple(lg32.shape)}")
        err32, _ = _held_prefix(torch, lg32, plain["float32"], 2e-4, None,
                                "whisper fp32 forward, K7 against its "
                                "plain twin")
        check(all(torch.isfinite(x).all().item() for x in (lg16, enc16)),
              "whisper's bf16 logits not finite")
        rms16 = {"flash": _rms(lg16, plain["float32"]),
                 "plain_twin": _rms(plain["bfloat16"], plain["float32"])}
        check(rms16["flash"] <= BF16_RMS_RATIO * rms16["plain_twin"],
              f"whisper bf16 forward: K7's rms error against the fp32 twin "
              f"{rms16['flash']} over {BF16_RMS_RATIO} x the bf16 twin's "
              f"{rms16['plain_twin']}")
        same_argmax = float((lg16.argmax(-1) == plain["bfloat16"].argmax(-1))
                            .float().mean())
        del lg32, plain
        # ROADMAP §3 F3 on the card: the flag-off encoder is causal
        moved = fr.clone()     # not a constant shift, which LayerNorm drops
        moved[:, -1] += frames(1, 1)[0, 0]
        f3 = {}
        for on in (False, True):
            c = flag[("bfloat16", on)]
            a, z = E.encode(params, c, fr), E.encode(params, c, moved)
            f3[on] = dict(
                earlier_frames_bitwise=bool(torch.equal(a[:, :-1],
                                                        z[:, :-1])),
                earlier_frames_max_abs_moved=(a[:, :-1] - z[:, :-1]).abs()
                .max().item(),
                last_frame_max_abs_moved=(a[:, -1] - z[:, -1]).abs().max()
                .item())
        check(f3[False]["earlier_frames_bitwise"]
              and not f3[True]["earlier_frames_bitwise"]
              and f3[True]["earlier_frames_max_abs_moved"] > 0,
              f"F3: frame 1499 should move frames 0-1498 with the flag on "
              f"only: {f3}")
        fwd_ms = {f"{dt}_{'flash' if on else 'chunked'}": _time(
            torch, lambda c=flag[(dt, on)]: forward(c, params, fr, tk),
            reps=3, warmup=1) for dt in ("bfloat16", "float32")
            for on in (True, False)}
        prof = profile_kinds(torch, lambda: forward(
            flag[("bfloat16", True)], params, fr, tk), lambda n: _kinds(n))
    say("whisper_forward", batch=b, frames=t, tokens=s,
        flash_launches_per_forward=n_k7, k7_calls_held=n_enc + n_dec,
        k7_calls_max_abs_err=held_err, k7_calls_max_row_rms_ratio=held_row,
        fp32_vs_plain_twin_max_abs_err=err32,
        fp32_tolerance="rtol 2e-4, atol 2e-4 * max|logits|",
        bf16_rms_err_vs_fp32_twin=rms16,
        bf16_tolerance=f"flash rms error <= {BF16_RMS_RATIO} x the bf16 "
                       "plain twin's",
        bf16_same_argmax_share_vs_twin=same_argmax,
        f3={"flag_off": f3[False], "flag_on": f3[True]},
        forward_ms=fwd_ms, **prof)
    del enc16, lg16, moved

    # (b) K7 at the encoder's shape
    k7 = time_flash(torch, K, dev, cfg, rate, flops, b, t, causal=False)

    # (c) prefill and greedy decode, fp32, flag off
    c32 = flag[("float32", False)]
    bd, n_steps = W_DEC_B, W_DECODE_STEPS
    fr4, prompt = fr[:bd], tk[:bd, :W_PROMPT]

    def greedy():
        cache = E.init_cache(c32, bd, W_PROMPT + n_steps, t,
                             dtype=torch.float32, device=dev)
        lg, cache = E.prefill(params, c32, fr4, prompt, cache)
        out, logits, step_ms = [prompt], [lg[:, :v]], []
        for i in range(n_steps):
            nxt = logits[-1].argmax(-1).to(torch.int32)
            out.append(nxt[:, None])
            pos = torch.full((bd,), W_PROMPT + i, dtype=torch.int32,
                             device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = E.decode_step(params, c32, nxt, pos, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg[:, :v])
        return torch.cat(out, 1), torch.stack(logits, 1), step_ms

    with torch.inference_mode():
        K.reset_launch_counts()
        toks, logits, step_ms = greedy()
        check(K.launch_counts()["flash_attention"] == 0,
              "the flag-off prefill/decode launched K7")
        again, logits2, _ = greedy()
        check(torch.equal(toks, again), "a second greedy run gave other "
              "tokens")
        full = forward(c32, params, fr4, toks)[1][:, W_PROMPT - 1:]
        check(torch.allclose(logits, full, rtol=2e-3, atol=2e-3),
              f"whisper prefill/decode against the teacher-forced forward: "
              f"max|diff| {(logits - full).abs().max().item()}")
        pd_err = (logits - full).abs().max().item()
        pd_bitwise = bool(torch.equal(logits, logits2))
        del full, logits, logits2
        K.reset_launch_counts()
        c16 = flag[("bfloat16", True)]
        cache = E.init_cache(c16, bd, W_PROMPT + n_steps, t, device=dev)
        lg, cache = E.prefill(params, c16, fr4, prompt, cache)
        torch.cuda.synchronize()
        launches["whisper_prefill"] = K.launch_counts()
        check(launches["whisper_prefill"]["flash_attention"] == n_enc
              and torch.isfinite(lg).all().item(),
              f"whisper's flag-on prefill: {launches['whisper_prefill']} "
              f"(expected {n_enc} K7 launches)")
        del cache, lg
    say("whisper_prefill_decode", batch=bd, prompt=W_PROMPT,
        decode_steps=n_steps, compute="float32", flash=False,
        max_abs_err_vs_forward=pd_err, tolerance="rtol 2e-3 atol 2e-3",
        repeated_run="same tokens", repeated_logits_bitwise=pd_bitwise,
        decode_step_ms=step_ms,
        decode_step_ms_median=float(np.median(step_ms[1:])),
        tokens=toks[0].tolist(),
        flag_on_prefill_k7_launches=launches["whisper_prefill"][
            "flash_attention"])
    del params, fr, tk, fr4, prompt, toks, again
    _free(torch)

    # (d) training through the Trainer: bf16, remat, flag off
    params, built = draw(train=True)

    def batch(step):
        return dict(frames=frames(b, 1000 + step), tokens=tokens(b, s, step))

    loss0, n_leaves = _grads_twice(
        torch, _grads_of, make_loss_fn(flag[("float32", False)], DistCtx()),
        params, batch(0), f"{W_ARCH} step 0 (fp32)")
    _free(torch)

    def stream():
        step = 0
        while True:
            yield batch(step)
            step += 1

    step_fn = make_train_step(cfg, DistCtx(), AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=W_TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(step_fn, stream(), TrainState(params, adamw_init(params)),
                 log_fn=lambda _s: None)
    t0 = time.perf_counter()
    losses = tr.run(W_TRAIN_STEPS)
    wall = time.perf_counter() - t0
    check(len(losses) == W_TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"{W_ARCH} did not train: {losses}")
    step_ms = [x * 1e3 for x in tr.step_times]
    say("whisper_training", batch=b, frames=t, tokens=s,
        compute=cfg.compute_dtype, remat=cfg.remat, flash=False,
        params=built["params"], ln_vocab=math.log(v), step0_fp32_loss=loss0,
        step0_gradients=f"{n_leaves} leaves, every one finite, bitwise "
                        "equal across two runs (fp32)",
        steps=W_TRAIN_STEPS, losses=losses, step_ms=step_ms,
        step_ms_median=float(np.median(step_ms[1:])),
        peak_gb=_peak_gb(torch), wall_s=round(wall, 3))
    del params, tr, step_fn
    _free(torch)
    say("phase19", wall_s=round(time.perf_counter() - t_phase, 3))
    return {"at_whisper": {k: x for k, x in k7.items()
                           if k not in ("name", "route", "source",
                                        "replaces")}}


# ---------------------------------------------------------------------------
# the distributed substrate on a virtual mesh (phases 11 (d) and 20)
# ---------------------------------------------------------------------------

def _overlap_total(a, b):
    """The total length of the intersections of two lists of (start, end)
    ms intervals, each sorted and disjoint (one stream's)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += _overlap_ms(a[i], b[j])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def mesh_timeline(torch, mesh, fn, pairs):
    """One call of ``fn`` with the mesh's log on: every transfer's interval
    on the side stream and every product span on the current stream, by
    CUDA events from one base event.  Per kind: count, ms (the sum of the
    intervals) and bytes; for each (transfer kind, span kind) of
    ``pairs``, the ms of the transfers that overlap those spans."""
    base = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    mesh.log = []
    torch.cuda.synchronize()
    base.record()
    try:
        fn()
        end.record()
        torch.cuda.synchronize()
        log = mesh.log
    finally:
        mesh.log = None
    at = base.elapsed_time
    by_kind = {}
    for e in log:
        iv = (at(e["start"]), at(e["end"]))
        k = by_kind.setdefault(e["kind"], dict(stream=e["stream"], count=0,
                                               ms=0.0, bytes=0, iv=[]))
        k["count"] += 1
        k["ms"] += iv[1] - iv[0]
        k["bytes"] += e["bytes"]
        k["iv"].append(iv)
    out = dict(pass_ms=at(end), by_kind={
        k: {f: x for f, x in v.items() if f != "iv"}
        for k, v in by_kind.items()})
    for copy, span in pairs:
        if copy in by_kind and span in by_kind:
            ov = _overlap_total(sorted(by_kind[copy]["iv"]),
                                sorted(by_kind[span]["iv"]))
            out[f"{copy}_overlapping_{span}_ms"] = ov
            out[f"{copy}_hidden_share"] = ov / max(by_kind[copy]["ms"],
                                                   1e-9)
    return out


def _mesh_kind(name):
    """A kernel's kind for the mesh phases' profiles."""
    return _kinds(
        name, ("copies (transfers, cuts, joins)", ("copy", "memcpy")),
        ("routing and sort", ("sort", "radix", "search", "softmax")),
        ("gathers", ("index", "gather", "scatter")))


def ring_tp_nemo(torch, K, dev, params, cfg, toks, flag, ref32, fwd,
                 launches):
    """Phase 11 (d): mistral-nemo-12b's forward with ring TP over a
    virtual (data 2, model 4) mesh, on phase 11's parameters: held to (a)'s
    no-mesh fp32 flag-on logits ``ref32``, and to (a)'s rms rule and bf16
    flag-on time (``fwd``, ``lm_forwards``' report)."""
    from repro_torch.dist import VirtualMesh
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    mesh = VirtualMesh(MESH_SHAPE, ("data", "model"), dev)
    ring, plain = T.DistCtx(mesh=mesh, use_ring_tp=True), T.DistCtx()
    b = toks.shape[0]
    f32, b16 = flag["float32"][True], flag["bfloat16"][True]

    def forward(c, ctx):        # the padded vocab's -1e30 columns left out
        return T.forward(params, c, toks, ctx=ctx)[0][..., :cfg.vocab]

    # (a)'s flag-on bf16 rms error against its fp32 (flag-off) logits: the
    # two fp32 references differ by ~1e-5, the bf16 errors by ~4e-3
    rms_plain = fwd["bf16_rms_err_vs_fp32"]["flash"]
    with torch.inference_mode():
        K.reset_launch_counts()
        got = forward(f32, ring)
        torch.cuda.synchronize()
        n32 = K.launch_counts()["flash_attention"]
        err32, _ = _held_prefix(torch, got, ref32, 2e-4, None,
                                "phase 11 (d): the fp32 ring-TP forward "
                                "against no mesh")
        del got
        K.reset_launch_counts()
        got = forward(b16, ring)
        torch.cuda.synchronize()
        launches["ring_tp_forward"] = counts = K.launch_counts()
        check(torch.isfinite(got).all().item(),
              "phase 11 (d): bf16 ring-TP logits not finite")
        rms_ring = _rms(got, ref32)
        del got, ref32
        check(rms_ring <= BF16_RMS_RATIO * rms_plain,
              f"phase 11 (d): the bf16 ring-TP forward's rms error against "
              f"fp32 {rms_ring} is over {BF16_RMS_RATIO} x no mesh's "
              f"{rms_plain}")
        check(n32 == counts["flash_attention"] == cfg.n_layers,
              f"phase 11 (d): K7 launched {n32} / {counts} times a ring-TP "
              f"forward, not {cfg.n_layers}")
        forward_ms = dict(ring_tp=_time(torch, lambda: forward(b16, ring),
                                        reps=3, warmup=1),
                          no_mesh=fwd["forward_ms"]["bfloat16_flash"])
        timeline = mesh_timeline(torch, mesh, lambda: forward(b16, ring),
                                 (("rotate", "matmul"),))
        prof = profile_kinds(torch, lambda: forward(b16, ring), _mesh_kind)

        # prefill of LM_PREFIX takes the ring; decode steps (S = 1) fall
        # back: from the same cache, bitwise the no-mesh steps
        c32 = flag["float32"][False]
        caches = [T.init_cache(c32, b, LM_PREFIX + 8, dtype=torch.float32,
                               device=dev) for _ in range(2)]
        mesh.log = []
        first = [T.prefill(params, c32, toks[:, :LM_PREFIX], cache,
                           ctx=c)[0] for c, cache in zip((ring, plain),
                                                         caches)]
        torch.cuda.synchronize()
        prefill_rotations = sum(e["stream"] == "side" for e in mesh.log)
        check(prefill_rotations > 0, "phase 11 (d): the prefill of "
              f"{LM_PREFIX} did not take the ring")
        scale = first[1].abs().max().item()
        check(torch.allclose(first[0], first[1], rtol=2e-4,
                             atol=2e-4 * scale),
              "phase 11 (d): the ring-TP prefill against no mesh")
        prefill_err = (first[0] - first[1]).abs().max().item()
        kv = caches[0]["kv"]
        twin = {"kv": dataclasses.replace(
            kv, k=kv.k.clone(), v=kv.v.clone(), key_pos=kv.key_pos.clone())}
        mesh.log = []
        for i in range(2):
            pos = torch.full((b,), LM_PREFIX + i, dtype=torch.int32,
                             device=dev)
            steps = [T.decode_step(params, c32, toks[:, LM_PREFIX + i], pos,
                                   cache, ctx=c)[0]
                     for c, cache in ((ring, caches[0]), (plain, twin))]
            check(torch.equal(steps[0], steps[1]),
                  f"phase 11 (d): decode step {i} with the ring-TP flag is "
                  "not bitwise the no-mesh step")
        torch.cuda.synchronize()
        check(not mesh.log, "phase 11 (d): a decode step took the ring")
        mesh.log = None
        del caches, twin, first, steps
    say("lm_ring_tp", arch=cfg.name, mesh=mesh.shape, batch=b,
        seq=toks.shape[1], fp32_max_abs_err=err32,
        fp32_tolerance="rtol 2e-4, atol 2e-4 * max|logits| (the "
                       "reference's ring-vs-SPMD tolerance)",
        bf16_rms_err_vs_fp32={"ring_tp": rms_ring, "no_mesh": rms_plain},
        bf16_tolerance=f"ring TP rms error <= {BF16_RMS_RATIO} x no mesh "
                       "(phase 11 (a)'s flag-on error, against its fp32 "
                       "flag-off logits)",
        flash_launches=counts["flash_attention"],
        forward_ms_bf16=forward_ms, timeline=timeline, profile=prof,
        prefill=LM_PREFIX, prefill_rotations=prefill_rotations,
        prefill_max_abs_err=prefill_err,
        decode="2 steps from one cache: no transfer, bitwise no mesh",
        wall_s=round(time.perf_counter() - t_phase, 3))


class _RoutePin:
    """Record every ``moe_lib._route`` call's expert ids in one run, then
    replay them in another: each call there takes the next recorded ids
    (``rows`` reorders a call's block of them, e.g. shard-major to the
    flat B x S order) with its gates from its own router logits at those
    ids.  Where its own top-k set differs (an fp32 near-tie of router
    logits: products of another shape, sums in another order), the gap
    between its own k-th logit and the pinned ids' least logit must be
    under ``tol`` x max|logit|; such rows are counted."""

    def __init__(self, torch, moe_lib, tol=1e-4):
        self.torch, self.lib, self.tol = torch, moe_lib, tol
        self.orig = moe_lib._route
        self.ids, self.pos, self.rows = [], 0, None
        self.differing = self.worst_gap = 0

    def record(self):
        def route(p, x2d, cfg):
            gates, tope = self.orig(p, x2d, cfg)
            self.ids.append(tope)
            return gates, tope
        self.lib._route = route

    def replay(self, rows=None):
        torch = self.torch
        flat = torch.cat(self.ids)
        self.pos, self.rows = 0, rows

        def route(p, x2d, cfg):
            logits = (x2d @ p["router"]["w"].to(x2d.dtype)).float()
            n = x2d.shape[0]
            pin = flat[self.pos:self.pos + n]
            self.pos += n
            if self.rows is not None:
                pin = pin[self.rows]
            own = torch.sort(logits, dim=-1, descending=True, stable=True)
            kth = own.values[:, cfg.top_k - 1]
            same = (own.indices[:, :cfg.top_k].sort(-1).values
                    == pin.sort(-1).values).all(-1)
            picked = torch.gather(logits, -1, pin)
            if not bool(same.all()):
                gap = (kth - picked.min(-1).values)[~same]
                self.differing += int((~same).sum())
                self.worst_gap = max(self.worst_gap, float(
                    gap.max() / logits.abs().max()))
            return torch.softmax(picked, dim=-1), pin
        self.lib._route = route

    def restore(self):
        self.lib._route = self.orig
        check(self.worst_gap <= self.tol,
              f"a replayed routing differs where the router logits are "
              f"{self.worst_gap} x max|logit| apart (more than a near-tie)")
        return dict(rows_pinned_off_their_own_choice=self.differing,
                    largest_gap_over_max_logit=self.worst_gap)


def _shard_major_rows(torch, b, s, mesh_shape, dev):
    """For each flat B x S token, its row in the shard-major order of the
    EP path (shard (d, j) holds batch rows d·B/D.. and positions j·S/M..)."""
    d, m = mesh_shape
    bl, sl = b // d, s // m
    bi = torch.arange(b, device=dev)[:, None]
    si = torch.arange(s, device=dev)[None, :]
    shard = (bi // bl) * m + si // sl
    return (shard * (bl * sl) + (bi % bl) * sl + si % sl).reshape(-1)


def _ep_oracle(torch, moe_lib, MeshSharding):
    """``moe_apply_ep_shard``'s oracle: ``moe_apply`` with all the experts
    on each shard's own token block, at that block's capacity."""
    def oracle(p, x, cfg, mesh, *, data_axes=("data",), model_axis="model",
               capacity_factor=None, pipeline_chunks=1):
        ep = mesh.shape[model_axis]
        seq = x.shape[1] % ep == 0 and x.shape[1] >= ep
        sh = MeshSharding(mesh, (tuple(data_axes),
                                 model_axis if seq else None, None))
        blocks = sh.cut(x)
        flat = blocks.reshape((-1,) + blocks.shape[mesh.ndim:])
        out = torch.stack([moe_lib.moe_apply(p, blk, cfg,
                                             capacity_factor=capacity_factor)
                           for blk in flat])
        return sh.join(out.reshape(blocks.shape))
    return oracle


def granite_mesh(torch, K, dev, launches):
    """Phase 20: granite-moe-1b-a400m at full width on a virtual (data 2,
    model 4) mesh: ring TP in attention, EP in every MoE layer."""
    from repro_torch import configs
    from repro_torch.dist import VirtualMesh
    from repro_torch.dist.sharding import MeshSharding
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    from repro_torch.train import (AdamWConfig, LMDataConfig, adamw_init,
                                   lm_batch, make_loss_fn, make_train_step)
    from repro_torch.train.trainer import _grads_of
    from repro_torch.train.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    mesh = VirtualMesh(MESH_SHAPE, ("data", "model"), dev)
    b, s = P20_B, P20_S
    ep = mesh.shape["model"]
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           vocab_multiple=16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    tokens_a_shard = b * s // mesh.size
    capacity = int(tokens_a_shard * cfg.top_k / cfg.n_experts
                   * cfg.moe_capacity_factor)
    say("moe_mesh_built", arch=cfg.name, mesh=mesh.shape,
        experts_a_shard=cfg.n_experts // ep, tokens_a_shard=tokens_a_shard,
        capacity_a_shard=capacity, init_s=round(time.perf_counter() - t0, 3))
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              use_flash_attention=True)
    b16 = dataclasses.replace(cfg, use_flash_attention=True)

    def ctx(chunks=1, ring=True):
        return T.DistCtx(mesh=mesh, use_ring_tp=ring,
                         moe_pipeline_chunks=chunks)

    def forward(c, x):
        return T.forward(params, c, toks, ctx=x)[0][..., :cfg.vocab]

    def held(got, want, what):
        scale = want.abs().max().item()
        check(torch.isfinite(got).all().item()
              and torch.allclose(got, want, rtol=2e-4, atol=2e-4 * scale),
              f"phase 20: {what}: logits disagree")
        return (got - want).abs().max().item()

    oracle = _ep_oracle(torch, moe_lib, MeshSharding)
    out = {}
    with torch.inference_mode():
        # (a) the fp32 EP forward (chunks 1) against its oracle; chunks 4
        # and ring TP off against it, every routing pinned to its ids
        pin = _RoutePin(torch, moe_lib)
        pin.record()
        try:
            ep32 = forward(f32, ctx(1))
        finally:
            moe_lib._route = pin.orig
        runs = {}
        orig_ep = moe_lib.moe_apply_ep_shard
        for name, c in (("oracle", ctx(1)), ("chunks_4", ctx(4)),
                        ("ring_tp_off", ctx(1, ring=False))):
            pin.replay()
            if name == "oracle":
                moe_lib.moe_apply_ep_shard = oracle
            try:
                got = forward(f32, c)
            finally:
                moe_lib.moe_apply_ep_shard = orig_ep
                runs[name] = pin.restore()
            runs[name]["max_abs_err"] = held(ep32, got, f"fp32 EP against "
                                             f"{name}")
            del got
        out["fp32"] = dict(max_abs_logit=ep32.abs().max().item(),
                           tolerance="rtol 2e-4, atol 2e-4 * max|logits|",
                           against=runs)
        # (b) bf16, flag on, chunks 1 and 4 (the main path: K7 counted),
        # its rms error against the fp32 EP forward at most BF16_RMS_RATIO
        # x the oracle's bf16 forward's (bf16 routes on its own logits:
        # nothing is pinned)
        moe_lib.moe_apply_ep_shard = oracle
        try:
            rms_oracle = _rms(forward(b16, ctx(1)), ep32)
        finally:
            moe_lib.moe_apply_ep_shard = orig_ep
        del pin
        rms16 = {}
        for chunks in P20_CHUNKS:
            K.reset_launch_counts()
            got = forward(b16, ctx(chunks))
            torch.cuda.synchronize()
            counts = K.launch_counts()
            launches[f"moe_mesh_forward_chunks{chunks}"] = counts
            check(counts["flash_attention"] == cfg.n_layers,
                  f"phase 20: K7 launched {counts} a forward")
            rms16[f"chunks_{chunks}"] = _rms(got, ep32)
            check(rms16[f"chunks_{chunks}"] <= BF16_RMS_RATIO * rms_oracle,
                  f"phase 20: bf16 EP chunks {chunks} rms error "
                  f"{rms16[f'chunks_{chunks}']} over {BF16_RMS_RATIO} x the "
                  f"oracle's {rms_oracle}")
            del got
        out["bf16"] = dict(rms_err_vs_fp32=dict(oracle=rms_oracle, **rms16),
                           tolerance=f"EP rms error <= {BF16_RMS_RATIO} x "
                                     "the oracle's")
        del ep32
        out["forward_ms_bf16"] = {
            name: _time(torch, lambda c=c: forward(b16, c), reps=2,
                        warmup=1)
            for name, c in (("chunks_1", ctx(1)), ("chunks_4", ctx(4)),
                            ("ring_tp_off_chunks_4", ctx(4, ring=False)),
                            ("no_mesh", T.DistCtx()))}
        out["timeline_chunks_4"] = mesh_timeline(
            torch, mesh, lambda: forward(b16, ctx(4)),
            (("rotate", "matmul"), ("all_to_all", "expert_ffn")))
        out["profile_chunks_4"] = profile_kinds(
            torch, lambda: forward(b16, ctx(4)), _mesh_kind)
        out["timeline_chunks_1"] = mesh_timeline(
            torch, mesh, lambda: forward(b16, ctx(1)),
            (("all_to_all", "expert_ffn"),))
        # (c) prefill + decode against the forward, at no-drop capacity
        nd = dataclasses.replace(f32, moe_capacity_factor=float(
            cfg.n_experts))
        errs = prefill_decode(torch, params, nd, toks, P18_PREFIX,
                              ctx=ctx(4))
    out["prefill_decode"] = dict(prefix=P18_PREFIX, capacity="no-drop",
                                 prefill_max_abs_err=errs[0],
                                 decode_max_abs_err=errs[1],
                                 tolerance="rtol 2e-3 atol 2e-3")
    say("moe_mesh_forward", arch=cfg.name, mesh=mesh.shape, batch=b, seq=s,
        **out)
    _free(torch)

    # (d) step 0's fp32 gradients at no-drop capacity (B 2, S P20_GRAD_S,
    # remat) on the mesh against no mesh, the routing pinned to the
    # mesh step's; then 10 AdamW steps on the mesh (bf16, capacity 1.25)
    g32 = dataclasses.replace(cfg, compute_dtype="float32",
                              moe_capacity_factor=float(cfg.n_experts))
    batch = _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=P20_GRAD_S, global_batch=b,
        doc_len=P20_GRAD_S), 0), dev)
    pin = _RoutePin(torch, moe_lib)
    pin.record()
    try:
        loss_m, _, grads_m = _grads_of(make_loss_fn(g32, ctx(4)), params,
                                       batch)
    finally:
        moe_lib._route = pin.orig
    pin.replay(rows=_shard_major_rows(torch, b, P20_GRAD_S, MESH_SHAPE,
                                      dev))
    try:
        loss_p, _, grads_p = _grads_of(make_loss_fn(g32, T.DistCtx()),
                                       params, batch)
    finally:
        pinned = pin.restore()
    worst = 0.0
    for gm, gp in zip(tree_leaves(grads_m), tree_leaves(grads_p)):
        scale = gp.abs().max().item()
        check(torch.isfinite(gm).all().item() and torch.allclose(
            gm, gp, rtol=TRAIN_GRAD_TOL, atol=TRAIN_GRAD_TOL * scale),
            "phase 20: step 0's mesh gradients against no mesh")
        worst = max(worst, (gm - gp).abs().max().item() / max(scale, 1e-30))
    del grads_m, grads_p, pin
    _free(torch)
    tbatch = lambda i: _to_dev(torch, lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=P20_TRAIN_S, global_batch=b,
        doc_len=P20_TRAIN_S), i), dev)
    step = make_train_step(cfg, ctx(4), AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=P20_STEPS))
    p, opt, losses, step_ms = params, adamw_init(params), [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(P20_STEPS):
        bt = tbatch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt, m = step(p, opt, bt)
        losses.append(m["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase 20: the mesh steps did not train: {losses}")
    say("moe_mesh_training", arch=cfg.name, mesh=mesh.shape,
        step0=dict(batch=b, seq=P20_GRAD_S, compute="float32",
                   capacity="no-drop", remat=cfg.remat,
                   loss_mesh=float(loss_m), loss_no_mesh=float(loss_p),
                   max_err_over_max_leaf=worst,
                   tolerance=f"rtol {TRAIN_GRAD_TOL}, atol "
                             f"{TRAIN_GRAD_TOL} x max|leaf|",
                   routing=pinned),
        steps=P20_STEPS, batch=b, seq=P20_TRAIN_S, compute=cfg.compute_dtype,
        remat=cfg.remat, moe_pipeline_chunks=4, losses=losses,
        step_ms=step_ms, step_ms_median=float(np.median(step_ms[1:])),
        peak_gb=_peak_gb(torch))
    del params, p, opt, step, toks
    _free(torch)
    left = torch.cuda.memory_allocated() / 1e9
    check(left < 1.0, f"phase 20: {left:.1f} GB still allocated before the "
          "launcher")
    ef_launcher(torch, dev)
    say("phase20", wall_s=round(time.perf_counter() - t_phase, 3))


def ef_launcher(torch, dev):
    """Phase 20 (e): the launcher with ``--devices 4 --ef-bits 8 --ring-tp
    --moe-pipeline-chunks 4``: ef on a pure-DP (4, 1) mesh, EP at ep 1,
    ring TP falling back; step 0's loss bitwise the same launcher's
    without ``--ef-bits``, the residual nonzero, the ef pass timed.  The
    depth is cut to P20_EF_LAYERS: at 24 layers the launcher's AdamW step
    alone peaks at 61 GB (phase 18), and the residual, its successor and
    the compressed mean add 16 GB more, over the card's 80."""
    from repro_torch import configs
    from repro_torch.dist import P, VirtualMesh, ef_allreduce_mean
    from repro_torch.launch import train as ltrain
    from repro_torch.train.tree import tree_leaves, tree_map

    full = configs.get_config(MOE_ARCH)
    cut = dataclasses.replace(full, n_layers=P20_EF_LAYERS)
    orig = configs.get_config
    configs.get_config = lambda arch: cut if arch == MOE_ARCH \
        else orig(arch)
    argv = ["--arch", MOE_ARCH, "--devices", "4", "--ring-tp",
            "--moe-pipeline-chunks", "4"]
    try:
        t0 = time.perf_counter()
        ef = ltrain.main(argv + ["--ef-bits", "8", "--steps",
                                 str(P20_STEPS)])
        ef_s = time.perf_counter() - t0
        plain = ltrain.main(argv + ["--steps", "1"])
    finally:
        configs.get_config = orig
    _, err = ef["state"].opt_state
    res = max(e.abs().max().item() for e in tree_leaves(err))
    check(ef["device"].startswith("cuda") and ef["devices"] == 4
          and ef["losses"][0] == plain["losses"][0] and res > 0
          and all(np.isfinite(ef["losses"])),
          f"phase 20: the launcher with --ef-bits: loss {ef['losses'][0]} "
          f"against {plain['losses'][0]} without, residual {res}")
    loss0 = plain["losses"][0]
    del plain
    _free(torch)
    params = ef["state"].params      # gradient-shaped leaves for the timing
    dp = VirtualMesh((4, 1), ("data", "model"), dev)
    specs = tree_map(lambda _: P(), params)
    with torch.inference_mode():
        ef_ms = _time(torch, lambda: ef_allreduce_mean(
            params, err, dp, ("data",), specs, bits=8), reps=3, warmup=1)
    n_bytes = sum(t.numel() for t in tree_leaves(params)) * 4
    say("moe_mesh_launcher", argv=argv + ["--ef-bits", "8"],
        cut=f"depth {P20_EF_LAYERS} of {full.n_layers} layers, full width",
        params=sum(t.numel() for t in tree_leaves(params)),
        mesh=dp.shape, losses=ef["losses"],
        step0_loss_without_ef=loss0, step0_bitwise=True,
        residual_max_abs=res, step_ms=ef["step_ms"],
        step_ms_median=float(np.median(ef["step_ms"][1:])),
        wall_s=round(ef_s, 3), ef_pass_ms=ef_ms,
        ef_pass_gradient_gb=n_bytes / 1e9)
    del ef, params, err
    _free(torch)



# ---------------------------------------------------------------------------
# the dry-run counts held on the card (phase 21)
# ---------------------------------------------------------------------------

# phase 21 (c): the reference's tests/multidev/dryrun_lite.py cells, at
# full width on a (2, 2) meta mesh; (d): xlstm-125m's train_4k on one shard
DRY_CELLS = (("granite-moe-1b-a400m", "train_4k"),
             ("xlstm-125m", "decode_32k"), ("whisper-base", "prefill_32k"))
DRY_CELLS_PATH = os.path.join(ROOT, "build", "phase21_cells.json")
DRY_CELLS_TIMEOUT = 300


def dry_run_cells(out_path):
    """Phase 21 (c) and (d) on meta tensors, the CPU's work alone: run by
    ``python3 chip_smoke.py --dry-run-cells OUT`` in a process of its own
    (no card: it is started with no CUDA device visible), beside the card's
    phases, so that its seconds hide behind theirs.  Writes each cell's
    record to ``out_path``."""
    sys.path.insert(0, SRC)
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape, mesh in [(a, s, (2, 2)) for a, s in DRY_CELLS] + [
            ("xlstm-125m", "train_4k", (1, 1))]:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, False, mesh=VirtualMesh(
            mesh, ("data", "model"), "meta"))
        out[f"{arch} {shape} {r['mesh']}"] = dict(
            flops=r["flops"], bytes_accessed=r["bytes_accessed"],
            collective_bytes=r["collectives"]["total_bytes"],
            per_op=r["collectives"]["per_op"],
            kernels=r["collectives"]["kernels"], memory=r["memory"],
            seconds=round(time.perf_counter() - t0, 3))
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_dry_run_cells():
    """Start :func:`dry_run_cells` in its own process (stopped at exit if
    it is still running); phase 21 waits for it."""
    import atexit

    os.makedirs(os.path.dirname(DRY_CELLS_PATH), exist_ok=True)
    if os.path.exists(DRY_CELLS_PATH):
        os.remove(DRY_CELLS_PATH)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dry-run-cells",
         DRY_CELLS_PATH], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return dict(proc=proc, started=time.perf_counter())


def dry_run_on_card(torch, K, flops, cells):
    """Phase 21: the dry-run counter (``launch/op_cost.py``,
    ``kernels/cost.py``) held to what ran on the card.  (a) Phase 3's
    served pass (products stand-in, 8 shards, ps 8, dist 1; GCN 16 x 2:
    two aggregations at D = 16), counted live on the card: its rotation
    bytes == ``dryrun_gnn``'s count of the same plan on meta (two
    aggregations) == ``collective_bytes`` a shard x 8 shards x 2, and its
    K1/K3 launches and bytes == the host plan's work (``plan_work``),
    exactly.  (b) Phase 11's mistral-nemo-12b bf16 flag-on B 2 x S 4096
    forward counted on meta: its dot flops == the same counter's on phase
    11's live forward on the card, as integers, and K7's records == 40 x
    K7's work at that shape; ``forward_mfu`` = the counted flops over phase
    11's timed forward over the card's bf16 peak.  (c) The reference's
    ``dryrun_lite`` cells at full width on a (2, 2) meta mesh: flops > 0,
    the train cell's collectives > 0, each cell's seconds.  (d) xlstm-125m
    train_4k on one shard: the parameters' and AdamW state's argument
    bytes == phase 17's on the card.  (c) and (d) run in their own process
    from phase 1 on (:func:`start_dry_run_cells`); the phase's own wall
    is at most 30 s."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.core import collective_bytes
    from repro_torch.launch import dryrun_gnn, op_cost
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    # (a) the served pass
    served = DRY.pop("served")
    plan, d, n_agg = served["plan"], served["d"], served["aggregations"]
    live = served["live"]
    t0 = time.perf_counter()
    meta = dryrun_gnn.count_ring(plan, d, served["arrays"])
    exact = dryrun_gnn.plan_work(plan, d)
    count_s = time.perf_counter() - t0
    rot = live.collectives.get("collective-permute", {})
    meta_rot = meta.collectives.get("collective-permute", {})
    model = collective_bytes(plan, d)
    check(rot.get("bytes") == n_agg * meta_rot.get("bytes", -1)
          == n_agg * model * plan.n_dev and rot.get("count") == n_agg
          * meta_rot.get("count", -1) == n_agg * plan.dist
          * (plan.n_dev - 1),
          f"phase 21 (a): rotations live {rot}, on meta {meta_rot}, "
          f"collective_bytes {model} a shard x {plan.n_dev} x {n_agg}")
    for name, w in exact.items():
        got = live.kernels.get(name, {})
        check(got == dict(launches=n_agg * w["launches"], flops=0,
                          bytes=n_agg * w["bytes"], exact=True)
              and meta.kernels[name]["launches"] == w["launches"],
              f"phase 21 (a): {name} live {got}, the host plan's {w} x "
              f"{n_agg}, on meta {meta.kernels.get(name)}")
    say("dryrun_served_pass", padded_rows=plan.padded_nodes,
        shards=plan.n_dev, config=dict(ps=plan.ps, dist=plan.dist), width=d,
        aggregations=n_agg, rotation_bytes=rot["bytes"],
        rotations=rot["count"], rotation_bytes_per_shard_per_aggregation=
        meta_rot["bytes"] // plan.n_dev, collective_bytes=model,
        live_kernels=live.kernels, plan_kernels=exact,
        meta_kernels=meta.kernels, live_count_s=served["seconds"],
        plan_and_meta_count_s=round(count_s, 3))
    del live, served, meta

    # (b) mistral-nemo-12b's forward on meta
    nemo = DRY.pop("nemo_forward")
    cfg = dc.replace(configs.get_config(LM_ARCH), compute_dtype="bfloat16",
                     use_flash_attention=True)
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           vocab_multiple=16, device="meta")
    toks = torch.empty((LM_B, LM_S), dtype=torch.int32, device="meta")
    with torch.inference_mode():
        oc = op_cost.analyze(T.forward, params, cfg, toks)
    meta_s = time.perf_counter() - t0
    k7 = K.cost.flash_attention(LM_B, LM_S, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, causal=True,
                                window=cfg.sliding_window, itemsize=2)
    want_k7 = dict(launches=cfg.n_layers, flops=cfg.n_layers * k7.flops,
                   bytes=cfg.n_layers * k7.bytes, exact=True)
    check(oc.dot_flops == nemo["dot_flops"] and
          oc.kernels["flash_attention"] == nemo["kernels"]["flash_attention"]
          == want_k7 and want_k7["flops"] == 40 * 274945015808,
          f"phase 21 (b): meta {oc.dot_flops} flops, {oc.kernels}; live "
          f"{nemo['dot_flops']}, {nemo['kernels']}; K7 {want_k7}")
    mfu = oc.dot_flops / (nemo["ms"] / 1e3) / flops["bfloat16"]
    say("dryrun_forward", arch=cfg.name, batch=LM_B, seq=LM_S,
        compute="bfloat16", flash=True, dot_flops=oc.dot_flops,
        dot_flops_live=nemo["dot_flops"],
        k7_flops=oc.kernels["flash_attention"]["flops"],
        products_flops=oc.dot_flops - oc.kernels["flash_attention"]["flops"],
        bytes_accessed=oc.bytes_accessed, forward_ms=nemo["ms"],
        peak_flops=flops["bfloat16"], forward_mfu=mfu,
        forward_mfu_is="counted flops / phase 11's timed bf16 flag-on "
                       "forward / the card's bf16 peak",
        meta_count_s=round(meta_s, 3))
    del params, oc

    # (c), (d) the cells, from their own process
    proc = cells["proc"]
    try:
        log, _ = proc.communicate(timeout=DRY_CELLS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"phase 21: the meta cells did not end in {DRY_CELLS_TIMEOUT} s")
    check(proc.returncode == 0 and os.path.exists(DRY_CELLS_PATH),
          f"phase 21: the meta cells' process failed: {log[-3000:]}")
    with open(DRY_CELLS_PATH) as f:
        got = json.load(f)
    for arch, shape in DRY_CELLS:
        r = got[f"{arch} {shape} 2x2"]
        check(r["flops"] > 0, f"phase 21 (c): {arch} {shape}: no flops")
        check(shape != "train_4k" or r["collective_bytes"] > 0,
              f"phase 21 (c): {arch} {shape}: no collectives")
    one = got["xlstm-125m train_4k 1x1"]
    sizes = one["memory"]["argument_sizes"]
    card_bytes = DRY.pop("xlstm_train_state_bytes")
    check(sizes[0] + sizes[1] == card_bytes,
          f"phase 21 (d): the dry run's parameters and AdamW state "
          f"{sizes[:2]} against {card_bytes} bytes on the card")
    say("dryrun_cells", mesh="2x2 (meta)",
        cells={k: {f: v[f] for f in ("flops", "bytes_accessed",
                                      "collective_bytes", "per_op",
                                      "seconds")}
               for k, v in got.items() if k.endswith("2x2")},
        xlstm_train_one_shard=dict(argument_sizes=sizes,
                                   card_state_bytes=card_bytes,
                                   seconds=one["seconds"]),
        process_s=round(time.perf_counter() - cells["started"], 3),
        cells_s=round(sum(v["seconds"] for v in got.values()), 3))
    say("phase21", wall_s=round(time.perf_counter() - t_phase, 3),
        budget_s=30)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dry-run-cells"]:
        dry_run_cells(sys.argv[2])
    else:
        main()
