#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases env,kernels

Phases, each printing one JSON line ({"phase": ...}); any failure raises and
the script exits non-zero:

1. env      - the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the build of the CUDA kernels from the sources in
              ssd_tpu_torch/csrc (seconds, each source's seconds, ptxas
              register/spill lines; for each instantiation of the split-KV paged kernels K2/K4 and
              tree kernels K3/K5, of K1's bf16 kernel, K6's two bf16
              routes and K9's kernels, its registers, spills and shared
              memory).
2. kernels  - each kernel against its plain PyTorch version on the card, at
              the Llama-3.2-1B geometry (Hq/Hkv 32/8, head_dim 64, 64-token
              pages; the paged kernels at decode Q=1 and at the SD/SSD verify
              Q=K+1=5; the tree kernels at K=4, 10 tree rows; batches with a
              ghost row), over the fp cache and over the int8 cache in both
              kv_quant modes ("int8", and "int8_mxu" as the [s8] entries), in
              fp32 (|err| <= 1e-4) and bf16 (|err| <= 1e-4 + 2^-7 |ref|: one
              bf16 rounding of the fp32 result), with TF32 off for matmuls
              and cuDNN. In the s8 mode kernel and plain version round the
              same integers, so the same tolerance holds. Then their times:
              the kernel, the plain version, one library call computing the
              same function (scaled_dot_product_attention on the gathered
              dense K/V, dequantized for the int8 cache: a yardstick the port
              never calls), and the bound (bytes, scales included, over the
              HBM rate or operations over the peak of their type); the paged
              kernels also at B=8 x 8192 tokens. The attention kernels are
              held against their plain versions again at Qwen3-30B-A3B's
              attention geometry (Hq/Hkv 32/4, head_dim 128: K2 and K4 in
              all three cache modes at the b8 decode, the Qwen3-MoE verify
              Q=K+1 (40 rows a KV head) and the glue Q=2K+1 (72 rows)), and
              K1 and K2 timed there. K2 and K4 must be batch-invariant bit
              for bit: a repeated call, each sequence alone against the
              batch of 8, and a Q=1 call against query 0 of a Q=K+1 call;
              K1 (bf16, fp and int8 pages, hd 64 G 4 and hd 128 G 8, block
              size 64) too: each serve prompt alone against its rows in the
              batch of 8. The grouped GEMM (K6) is held against its plain
              version at Qwen3-30B-A3B's expert shapes (gate/up 2048 -> 768,
              down 768 -> 2048; the serve prompts' prefill dispatch of
              5534 x 8 rows on the prefill route, a b8 decode dispatch of 64
              rows and a b1 one of 8 one-row groups on the decode route,
              group sizes from a seeded router with an empty group) and
              timed there,
              beside torch._grouped_mm as its yardstick (a dense matmul of
              the same operations where that call is missing or refuses).
              At Llama-3.1-8B's heads (Hq/Hkv 32/8, hd 128): K1 at the EAGLE
              draft prefill of the 8 serve prompts; K2 and K4 (both int8
              modes) at the EAGLE glue shape Q = 2K+1 with per-sequence
              qeff, the b8 decode (Q=1), the verify (Q=K+1) and the head's
              chain step (Q=1); K3 and K5 at the last tree step; both
              dtypes, then K1, the glue and K3/K5 (both int8 modes) at the
              last tree step timed. K3/K5 are timed at the Llama-3.2-1B
              b8 tree step and at B=1 over 2048 positions (tree_b1) too.
              The two bench probes: the s8 dot's three paths
              (csrc/s8_probe.cu: mma.sync s8, __dp4a, bf16 mma after a cast)
              exact against the fp64 plain version at s8_probe.CHECK_SHAPES
              (bench/s8_probe.py's shape, 4096 positions, one row block,
              D = 64, tails past a whole 64-position tile), timed at the
              probe's shape and at 4096 positions beside torch.bmm, and
              the paged kernels' stage variants (full, dma,
              compute, empty; K2 and K4's int8 mode) at the decode b8 batch
              and at B=8 x 8192, "full" bit for bit the production kernel;
              timed, then run once through their bench entry points
              (python -m ssd_tpu_torch.bench.s8_probe / .kernel_diag), whose
              launches the kernels line reports as the path "probe".
              K9, the W8A16 GEMM of int8 weights (csrc/int8_weight_gemm.cu),
              against its plain version with bf16 x (bf16 output; the LM
              head's fp32) on each wgmma route forced in turn (decode,
              prefill; two calls bit-equal) and fp32 x (the SIMT route), at
              Llama-3.2-1B's projections (q/o, k/v, gate/up, down) at 8, 40,
              80 and 128 rows, its LM head at 8 and 80 rows, the serve
              prompts' prefill (5534 rows) at gate/up and down, and
              Qwen3-30B-A3B's expert gate and down at a b8 decode dispatch
              (64 rows over 53 experts) and b1's 8 one-row groups; timed
              there in bf16 on the route rule's route beside its bound and
              two yardsticks the port never calls
              (torch._weight_int8pack_mm where it runs on the card, and the
              bf16 product on the dequantized weight, labelled: what the
              int8 path must beat). The shared-x launch (q/k/v, gate/up,
              the experts' gate/up in one launch) bit for bit the separate
              calls, within tolerance of the plain version, timed against
              them; a CUDA graph replay of it and of a split-K call bit for
              bit their eager calls.
              The shapes of one tensor-parallel rank: K1, K2/K4 and K3/K5
              at Llama-3.1-70B's per-rank heads (16/2 at tp 4, 8/1 at tp 8,
              hd 128) in both dtypes and every cache mode against their
              plain versions, timed at tp 4 (at_llama31_70b_tp4); K9 at its
              tp-4 projections (q 8192 -> 2048, k/v -> 256, o 2048 -> 8192,
              gate/up -> 7168, down 7168 -> 8192, the LM head's vocabulary
              slice -> 32,064) at 8 and 40 rows; K6 and K9 over one
              expert-parallel rank's groups (Qwen3-30B-A3B at tp 2), whose
              offsets end before the other rank's rows.
              Every head width: K1-K5 at hd 32, 48, 80, 96, 100, 192 and
              256 (heads 8/8, G = 1, at 32, 80, 100 and 256; 8/2 at the
              others) against their plain versions in fp32 and bf16: K2/K4
              at a decode and a verify of 4 sequences with a ghost row, K1
              over a mixed prefill with cached prompts and padding, K3/K5
              at the last tree step; the "int8" mode everywhere, int8_mxu's
              s8 arithmetic where JAX's router takes it (hd 192, 256); then
              K1 (fp and int8 pages), K2, K4 and K3/K5 timed in bf16 at
              OpenLLaMA-3B's heads (32/32, hd 100; at_open_llama_3b_hd100).
3. serve    - LLM(...).generate at the full Llama-3.2-1B width (16 layers,
              random bf16 weights from a seed): 128 greedy tokens for 8
              prompts of mixed length, then for 1 prompt (the AR path), each
              run with the engine's CUDA graphs (the default on the card:
              one graph per decode step and batch bucket, captured at init)
              and with them detached (what enforce_eager=True runs), in turns
              (graph, eager, graph; six turns until the eagle_tp phase
              came, four until the head_dims phase did): decode tok/s of every repeat with min / median /
              max, graph replays a decode step, capture seconds and the
              memory the captures reserved. Then the same with AR
              multi-step (multi_step=4).
              The kernels' launch counts are zeroed just before each run and
              read just after; a graph run's must be above zero and equal
              the eager run's, and both modes' tokens must agree over the
              runs that find the prompts in the prefix cache (all but the
              first: a cached prompt recomputes only its last token, through
              GEMMs of other shapes, which can flip a near tie).
4. spec     - sync SD, async SSD (unfused: a draft thread on its own
              stream, with one draft or two draft_dp replicas on the card;
              the fused exchange, async_fused; the fused async
              superstep, async_fused with spec_rounds 4 and 8), fused sync
              SD (spec_rounds 4 and 8) and ngram speculation (no draft: the
              last 3 tokens matched against the sequence's history, 4
              rounds a step) (K=4, fan-out 2, so 10 tree rows per sequence
              for SSD)
              through LLM(target, draft=..., speculate=True, ...) at the same
              width: a target of 16 layers whose layers >= 4
              have o_proj = down = 0 and a 4-layer draft sharing its live
              layers (the construction of the JAX package's bench.py), bf16.
              128 greedy tokens at b8 and b1, with the draft exact (the hit
              path) and perturbed by a fixed noise level (the miss path; SD
              and the async forms),
              whose async cache-hit rate must land between 0.2 and 0.8.
              Every mode runs graphs (the unfused SSD draft its own, on its
              thread's stream), and SD, SSD, the exchange, the R=4
              superstep, fused SD and ngram eagerly beside them in turns
              (graph, eager, graph) at b8 noise 0 (SD at b1 too), and
              unfused SSD with draft_dp 1 and 2 at b8 in four turns (graph,
              eager, graph, graph) and at b1 in three: decode tok/s
              min / median / max, hit rates, accepted lengths and the rows
              each replica served; both replicas must serve rows at b8;
              their tokens (and the async forms' hits and accepted lengths)
              must agree over the runs that find the prompts in the prefix
              cache (all but the first; see serve); every graph run must
              replay graphs, and every async run launch the tree kernel.
              One engine per mode serves its noise levels: the draft is
              perturbed in place and the prefix caches emptied between.
              Per run: decode
              tok/s, accepted suffix length, hit rate, verify and draft step
              times, the superstep's time, graph replays a step, and the
              overlap on the card of the draft's tree builds
              (draft stream) with the target's verifies (target stream),
              from CUDA events. Launch counts are zeroed before and read
              after each run, with the draft thread drained on both sides
              so that a run counts its own tree builds whole; every kernel
              must launch on each path.
5. kvq      - the int8 KV cache at the same width: AR b8 (serve's engine)
              and SD and SSD b8 at noise 0 (spec's pair) with
              kv_quant="int8", then AR and SSD b8 with "int8_mxu". Per run
              as in spec, plus the KV pool's block bytes and uncapped block
              count; every run must replay graphs (SSD's draft its own), the
              int8 kernels of each path must launch and the fp-cache kernels
              must not.
6. moe      - Qwen3-30B-A3B (Qwen3-MoE: 48 layers, 128 experts, top-8,
              hd 128, random bf16 weights from a seed) at full width and
              depth through LLM(...).generate with
              gpu_memory_utilization=0.92 (the default 0.7 of the card is
              less than the 61 GB of weights): 128 greedy tokens for the 8
              serve prompts, then for one of 512, with graphs and eagerly in
              turns as in serve (b8 and b1 three runs each). It fails if the free
              memory at its start is below the weights plus the capped KV
              pool, if the pool holds fewer blocks than the cap of 1224, if
              K1, K2 or the grouped GEMM never launched (counts zeroed just
              before, read just after), or if graph and eager tokens differ.
7. quant    - int8 weights (quantization="int8": every projection, the
              experts and the LM head in int8 with fp32 per-channel scales,
              quantized at load from random bf16 weights) at full width and
              depth: the Llama-3.2-1B AR engine (serve's) at b8 and b1,
              graph and eager in turns (graph, eager, graph), 128 tokens
              (an eager turn 64, held to the graph turns' first 64);
              fused SD (4 rounds) and unfused SSD at b8 under graphs on
              spec's pair at noise 0, target and draft both int8; and
              Qwen3-30B-A3B AR b8/b1, graph and eager in turns. Per engine
              decode tok/s, TTFT, replays a step, launches, each runner's
              weight bytes, the KV pool beside the bf16 engine's (serve's,
              moe's) and peak memory. It fails if K9 never launches, if K6
              launches on the int8 MoE engine, if graph and eager tokens
              differ, if a graph run replays no graph, or if a runner holds
              an LM head that is not int8.
8. eagle    - EAGLE-3 async SSD (K=4, fan-out 2) and the fused sync
              superstep (K=4, 4 rounds a step) at Llama-3.1-8B's
              geometry (32 layers, rope theta 5e5 without the published
              rope scaling, which neither package reads) with its EAGLE-3
              head's (1 layer, draft vocab 32000, 2048 positions, which cap
              max_model_len; so serve's 1900-token prompt is cut to 1875),
              random bf16 weights from a seed, 128 tokens: AR b8/b1 under
              graphs; EAGLE SSD and fused EAGLE b8, and EAGLE SSD b8 over
              the int8 cache, each with graphs and eagerly in turns on one
              engine (graph, eager; an eager turn serves 64 tokens, cut
              from 128 to hold the run's time; b8 and b1 ran graph, eager,
              graph until the eagle_tp phase came), and both forms b1
              under graphs:
              decode tok/s min / median / max, hit rate, accepted length,
              replays and launches a step, capture seconds and pool bytes;
              an eager turn's tokens must equal the graph turns' first 64.
              Then the constructed pair of
              bench.py::build_eagle_checkpoints (target cut to 8 layers):
              at noise 0 both forms must accept >= K tokens a step and
              async SSD hit above 0.9, and one noise level of a fixed
              ladder must put async SSD's hit rate in [0.2, 0.8]. Per run
              as in spec, plus TTFT and the pools; every graph run must
              replay graphs; K1 (target and draft prefill), K2 (verify,
              chain, glue) and, async, K3 (tree), or over the int8 cache
              their int8 kernels, must launch, and the fused form must not
              launch K3.
9. exact    - the same width in fp32 from random checkpoints (init scale
              0.4): AR at 2 layers, greedy tokens on the card equal those of
              device="cpu", with the smallest top-1/top-2 logit margin seen;
              then a target of 3 layers and a noisy 2-layer draft: AR, sync
              SD, async SSD, the fused exchange and the fused superstep
              (4 rounds) on the card under graphs, over the fp32 and the
              int8 cache, AR on the CPU over each (its SD and SSD were cut
              to hold the run's time), and on the card AR multi-step, fused SD
              (4 rounds), ngram and async SSD with draft_dp=2 under graphs
              over the fp32 cache, all equal the card's eager AR of the same
              cache (seconds per engine reported); so do sync SD, fused SD
              and async SSD with the draft as a reduced-vocabulary draft
              (an explicit head of 16384 rows and d2t, FR-Spec style); and
              two card runs of int8_mxu AR give the same tokens. Then
              Qwen3-30B-A3B's width at 1 layer: the CPU's AR, the card's
              graph AR, sync SD and async SSD (graphs;
              self-draft) equal the card's eager AR, with the smallest
              top-1/top-2 logit margin and the smallest router gap between
              the k-th and (k+1)-th expert (eager runs only: a graph's
              capture reads nothing back).
              Then the same width at 2 layers with the constructed EAGLE-3
              head (noise 0.028), over the fp32 and the int8 cache: the
              CPU's AR, and on the card EAGLE SSD and fused EAGLE (4
              rounds) under graphs, equal the card's eager AR of the same
              cache (the CPU's EAGLE runs were cut to hold the run's
              time). With int8
              weights (fp32 engines; a draft's or head's per-channel scales
              perturbed in place of its weights): at the 1B width the card's
              graph AR, SD and SSD and the CPU's AR, at Qwen3-30B-A3B's the
              card's graph AR and the CPU's AR, and with the EAGLE head the
              card's EAGLE SSD and fused EAGLE and the CPU's AR, each equal
              the card's eager AR of the same weights, and K9 launches in
              every card run.
10. profile - (only when asked for) the device's busy share, kernels and
              graph replays a step and top kernels over a prefill step and
              a window of decode steps at b=8, with graphs and eagerly;
              moe_profile the same on the `moe` engine; quant_profile and
              quant_moe_profile the same on their int8-weight engines.
11. spec_profile - (only when asked for) the same for sync SD, unfused
              async SSD, the exchange and the R=4 superstep under graphs at
              b=8: per step, the device time of each CUDA stream, their
              union, the time two streams (or a graph's two branches) ran
              kernels at once, the host-device copies and the verify's host
              time; eagle_profile the same for EAGLE SSD and the fused EAGLE
              superstep (4 rounds) under graphs on the eagle engine.
12. spec_async - (only when asked for) the three async forms (SSD, the
              exchange, the superstep at R=4 and 8) at b8 and b1, noise 0
              and 0.04, graphs against eager in turns, three runs each:
              decode tok/s min / median / max, hit rate, accepted length,
              replays and launches a decode step, capture seconds and pool
              bytes. spec_draft_rank (only when asked for, two cards or
              more): the NCCL draft rank's fp32 check of tp, then unfused
              SSD on spec's pair at b8 and b1 with the draft beside the
              target against the draft on cuda:1, in turns, three runs
              each: decode tok/s, hit rate, accepted length, the
              exchange's ms a step.

13. tp     - tensor and expert parallelism (num_devices > 1,
              ssd_tpu_torch/parallel) on one card, random weights from a
              seed, the target its own draft. The full-width, full-depth
              Llama-3.2-1B AR and fused SD (R=4) engines (bf16, b8, 64
              tokens) built over a one-rank NCCL group that this script
              initialises equal the same engines without a group bit for
              bit under graphs: greedy tokens, and the logits of a decode
              (AR) or verify (fused SD) forward over the 8 prefilled serve
              prompts; the collectives run inside the replays (counted
              through them), none without the group. Then two processes
              share the card over a gloo group (NCCL refuses two ranks on
              one card), eagerly: the 1B geometry at 4 layers (fp32 AR,
              fused SD R=4 and the fused exchange; bf16 AR) and
              Qwen3-30B-A3B's at 2 layers (expert parallel; fp32 AR and
              fused SD, bf16 AR), 4 prompts of 40-600 tokens, 32 tokens
              each: fp32 greedy tokens equal the card's tp-1 engine's (bf16:
              tokens agreeing and the first differing step), the kernels of
              each path and the all-reduce launch at the per-rank heads
              (16/4 and 16/2). With two cards or more, the engine also
              spawns its second rank on cuda:1 over NCCL under graphs.
              Then the unfused async draft on a rank of its own
              (ssd_tpu_torch/parallel/draft_rank.py): two processes share
              the card over gloo, the target and its draft rank, eagerly;
              the 1B geometry at 4 layers, fp32 async SSD, 4 prompts, 32
              tokens each: tokens equal the card's single-process SSD, K1
              and K2 launch in the target, K1, K2 and K3 in the draft rank
              (which reports its counts), with the exchange's ms a step.
              With two cards or more, the same with the draft rank on
              cuda:1 over NCCL under graphs.
14. eagle_tp - EAGLE-3 under tensor parallelism on one card over gloo,
              eagerly (NCCL refuses two ranks on one card): Llama-3.1-8B's
              width cut to 8 layers with its EAGLE-3 head (1 layer, draft
              vocab 32000), random fp32 weights from a seed, 4 prompts of
              40-600 tokens, 32 tokens each. The fused sync superstep (K=4,
              4 rounds) at tp 2 (two processes, the head sharded beside
              the target) and async EAGLE (K=4, fan-out 2) at tp 2 with the
              head on a draft rank of its own (three processes): greedy
              tokens of every target rank equal the card's tp-1 engine's
              (eager); K1 and K2 launch in every target rank and, async,
              K1, K2 and K3 in the draft rank, with the all-reduce; the
              exchange's ms a step.
15. eagle_tp_cards - (only when asked for, four cards; it prints a line
              saying it skipped with fewer) Llama-3.1-70B's geometry (80
              layers) with its EAGLE-3 head, random bf16 weights, NCCL,
              under graphs: the fused superstep (4 rounds) at tp 4, and
              async EAGLE at tp 2 with int8 weights (the target's 70 GB
              over two cards) and the head on a draft rank on the third
              card; 128 greedy tokens at b8 (serve's prompts, the longest
              cut to the head's 2048 positions) and b1: decode tok/s, hit
              rate, accepted length, the exchange's ms a step, launches
              and collectives a run, each engine's exit seconds; then K1,
              K2 and K3/K5 timed at the per-rank heads (16/2 at tp 4) and
              at the async head's whole heads (64/8, G 8) beside SDPA and
              their bounds.

16. head_dims - OpenLLaMA-3B (openlm-research/open_llama_3b_v2's
              config.json, num_key_value_heads and rope_theta stated: 26
              layers, width 3200, 32/32 heads of 100, so G = 1, MLP 8640,
              vocabulary 32000, 2048 positions) at full width and depth,
              random bf16 weights from a seed, every engine under graphs,
              64 greedy tokens: AR b8 and b1, sync SD and async SSD b8
              (K=4, fan-out 2; the target's layers >= 4 pass-through and
              its first 4 the draft, as bench.py::build_spec_checkpoints
              builds them), AR and SSD b8 over the int8 cache and over
              int8_mxu's: decode tok/s, accepted length, hit rate,
              launches. It fails if a run replays no graph, if a kernel of
              the run's path never launched or one of the other cache did,
              if K1-K5 never launched, or if int8_mxu's tokens differ from
              int8's (at hd 100 JAX's router takes no s8 kernel, so the
              arithmetic is the same); then fp32 at the same width cut to
              3 layers with a noisy 2-layer draft: AR, SD and SSD under
              graphs over the fp32 cache, AR and SSD over the int8 cache,
              each equal to the card's eager AR of its cache.
17. cli     - the port's CLIs (ssd_tpu_torch/bench/) through main(argv)
              on the card: compare_outputs on exact's fp32 pair (the
              Llama-3.2-1B width, 3 layers of which 2 live, a noisy 2-layer
              draft) with a 40-token id prompt, 48 tokens: AR, SD, fused SD
              (spec_rounds 8) and SSD, each a fresh engine under graphs,
              must print three EXACT MATCH lines and return 0; bench at
              spec's full-depth 16-layer bf16 pair, AR b8 and async SSD b8
              (K=4, fan-out 2, the 4-layer draft), 8 random-id prompts of
              128 tokens, 64 tokens each, one warm-up pass: its tok/s
              lines; one scripted chat turn in engine mode on the 16-layer
              target with a token-id stand-in tokenizer, streamed, with
              TTFT and tok/s. The kernels' launch counts are zeroed before
              the phase and read after it (path "cli"); K1-K3 must have
              launched.

18. hosts   - multi-host serving (num_hosts=2, ssd_tpu_torch/parallel/
              comm.py) on one card: two "host" processes with one rank
              each on cuda:0 join through the TCP rendezvous at a free
              port on 127.0.0.1, which picks gloo (the ranks share a card;
              NCCL cannot hold two ranks on one), eagerly. (a) The
              Llama-3.2-1B width at 4 layers, random fp32 weights, the
              target its own draft, 4 prompts of 40-600 tokens at
              max_num_seqs 2, 32 tokens each: AR with continuous
              batching, fused SD (R=4) and async SSD at draft_dp=2 (one
              replica a host, the hosts' replies unioned): each host's
              tokens, hit rates and accepted lengths equal the card's
              tp-1 engine's; K1 and K2 launch on both hosts, K3 and the
              union where SSD runs; the rendezvous seconds and the
              union's ms and bytes a step (and, timed apart before it, the
              wait for the draft's reply on the card). (b) The full-depth
              1B in bf16, AR b8 (serve's 8 prompts, 16 tokens): decode
              tok/s through the two hosts against the same engine as a
              gloo tp-2 group of the caller's (the tp phase's layout, the
              same ranks), in turns (hosts, tp 2, tp 2, hosts); every
              turn's tokens must be equal.
19. hosts_cards - (only when asked for, four cards; it prints a line
              saying it skipped with fewer) Llama-3.1-70B's geometry (80
              layers, random bf16 weights) as two hosts of two cards each
              (CUDA_VISIBLE_DEVICES 0,1 and 2,3; each host spawns its
              second rank) over NCCL with the TCP rendezvous, under
              graphs, against the same engines as one host of four cards
              (a FileStore group, num_hosts=2 without a coordinator): AR
              b8 and b1 and async SSD b8 (K=4, fan-out 2, the Llama-3.2-1B
              geometry as the draft, draft_dp=2: one replica a host), 128
              greedy tokens: token agreement, decode tok/s, graph replays
              and collectives a decode step, the union's ms and bytes a
              step and the wait for the draft's reply before it.

20. diag    - the step-decomposition tools (ssd_tpu_torch/bench/sd_diag.py,
              fasync_diag.py, prefill_diag.py) through main(argv) at the
              full Llama-3.2-1B width (random bf16 weights; target 16
              layers, draft 4 or an EAGLE-3 head at the target's width),
              each variant R rounds (or prefills) as one CUDA graph, the
              least of 3 replays: sd_diag (full, draft, verify; K=4, R=16,
              B=1) and with --eagle, fasync_diag (full, build, verify, fork,
              sync; F=2, R=8) at B=1 and B=8, prefill_diag (full, no_kernel,
              no_attn, matmul, head) at 2048 tokens, R=4. It fails unless
              each full variant's replay equals the production function
              called eagerly bit for bit, every variant's ms a round is
              finite and above 0, and the launches match the
              decomposition: prefill full launches K1 once a layer a
              prefill and the stripped prefills no K1 or K2, sd's full,
              draft and verify launch K2 and no K3, fasync's full K2 and
              K3, its sync K2, its build K3 and its fork no attention
              kernel (a variant with no count is a fault). One "diag" line with every tool's JSON;
              the launches are read under the path "diag". `--phases
              env,diag_profile` runs the same with each variant replayed
              once more under torch.profiler (kernel time a round per
              stream, the top kernels; line "diag_profile").

Then the {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time

try:
    # The card's peaks (H100 SXM data sheet) and its name and power limit.
    from ssd_tpu_torch.bench.card import (
        HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_OPS_INT8, name_and_power_limit)
    from ssd_tpu_torch.bench.diag_timing import LLAMA_1B_WIDTH
except ImportError:   # outside a checkout of the repository: main() says so and exits
    LLAMA_1B_WIDTH = {}   # before any phase reads it

PHASES = ("env", "kernels", "serve", "spec", "kvq", "moe", "quant", "eagle", "exact", "tp",
          "eagle_tp", "head_dims", "cli", "hosts", "diag")
EXTRA_PHASES = ("profile", "moe_profile", "quant_profile", "quant_moe_profile", "spec_profile",
                "eagle_profile", "spec_async", "spec_draft_rank", "eagle_tp_cards",
                "hosts_cards", "diag_profile")

# Llama-3.2-1B geometry (the JAX package's bench.py random-weight config):
# the package's width, its 16 layers, a tied head and its eos.
LLAMA_1B = {**LLAMA_1B_WIDTH, "num_hidden_layers": 16, "tie_word_embeddings": True,
            "eos_token_id": 128001}
LLAMA_HEADS = (32, 8, 64)   # Hq, Hkv, head_dim
# Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B, config.json): the MoE
# phase's model, at full width and depth.
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe",
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "tie_word_embeddings": False,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
}
MOE_GEOMETRY = "Qwen3-30B-A3B (48 layers, 128 experts, top-8, random bf16 weights)"
# Llama-3.1-8B (huggingface.co/meta-llama/Llama-3.1-8B, config.json) as both
# packages compute it: rope theta 5e5 without the published llama3
# rope_scaling, which neither ssd_tpu nor the port reads. The eagle phase's
# target, at full width and depth.
LLAMA_8B = {**LLAMA_1B, "hidden_size": 4096, "intermediate_size": 14336,
            "num_hidden_layers": 32, "head_dim": 128, "max_position_embeddings": 131072,
            "tie_word_embeddings": False}
LLAMA8B_HEADS = (32, 8, 128)
# Its EAGLE-3 head (huggingface.co/yuhuili/EAGLE3-LLaMA3.1-Instruct-8B,
# config.json): one layer at the target's width, a 32000-token draft vocab,
# 2048 positions (which cap max_model_len, as in ssd_tpu/config.py).
EAGLE3_8B = {"model_type": "llama", "vocab_size": 128256, "draft_vocab_size": 32000,
             "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 1,
             "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
             "max_position_embeddings": 2048, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
             "tie_word_embeddings": False, "eos_token_id": 128001}
EAGLE_GEOMETRY = ("Llama-3.1-8B (32 layers, rope theta 5e5 unscaled) + EAGLE-3 head "
                  "(1 layer, draft vocab 32000), random bf16 weights")
EAGLE_MAX_LEN = 2048                # the head's max_position_embeddings
EAGLE_PAIR_LAYERS = 8               # the constructed pair's target depth (cut from 32)
EAGLE_NOISE_LADDER = (0.028, 0.032, 0.036, 0.04, 0.045)   # searched for the miss path
EXACT_EAGLE_NOISE = 0.028           # the exact phase's EAGLE head noise: the eagle phase's miss level on an H100
QWEN_HEADS = (32, 4, 128)
# Llama-3.1-70B (huggingface.co/meta-llama/Llama-3.1-70B, config.json: 64
# query and 8 k/v heads of 128, width 8192, MLP 28672, vocabulary 128256) as
# one rank of a tensor-parallel engine holds it (ssd_tpu_torch/parallel/
# mesh.py): at tp 4 16/2 heads, at tp 8 8/1; its tp-4 projections.
L70B_TP_HEADS = {"tp4": (16, 2, 128), "tp8": (8, 1, 128)}
# OpenLLaMA-3B (huggingface.co/openlm-research/open_llama_3b_v2, config.json:
# LlamaForCausalLM, 26 layers, width 3200, 32 heads of 100, MLP 8640,
# vocabulary 32000, eps 1e-6, 2048 positions, untied head). Its config.json
# omits num_key_value_heads and rope_theta, for which both packages default
# to 8 and 5e5 where HF takes 32 and 1e4: stated here. The head_dims phase's
# model, at full width and depth: hd 100 (no multiple of 16; a bf16 V half
# 200 bytes into the slot row) and G = 1.
OPEN_LLAMA_3B = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
                 "vocab_size": 32000, "hidden_size": 3200, "intermediate_size": 8640,
                 "num_hidden_layers": 26, "num_attention_heads": 32, "num_key_value_heads": 32,
                 "max_position_embeddings": 2048, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
                 "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2}
OPEN_LLAMA_HEADS = (32, 32, 100)
HEAD_DIM_WIDTHS = (32, 48, 80, 96, 100, 192, 256)   # K1-K5 held to their plain versions at each
HD_NEW = 64                         # tokens a head_dims run serves (serve's 1900-token
                                    # prompt + 64 + the tree lookahead fit 2048 positions)
L70B_TP4 = {"D": 8192, "q": 2048, "kv": 256, "ffn": 7168, "vocab": 128256 // 4}
TP_RANKS = 2                        # the tp phase's ranks on one card (gloo)
TP_LENS = [40, 130, 300, 600]       # its prompts
TP_NEW = 32                         # and tokens each
MOE_UTIL = 0.92   # gpu_memory_utilization: 0.7 of the card is less than the weights
BLOCK = 64
SERVE_M = 4                         # AR multi-step tokens a step (serve_multi_step)
SERVE_LENS8 = [33, 111, 250, 400, 640, 900, 1300, 1900]  # serve phase, b8
SPEC_K, SPEC_F = 4, 2               # speculation depth, async fan-out
SPEC_MQ = SPEC_F * (SPEC_K + 1)     # tree rows per sequence
SPEC_LIVE = 4                       # draft layers = the target's live layers
SPEC_MAX_LEN = 2112                 # 1900 + 128 tokens + the tree lookahead
MISS_NOISE = 0.04                   # draft noise of the miss path
NGRAM_N = 3                         # ngram speculation: match the last 3 tokens
SPEC_R = 4                          # its rounds a step
MISS_HIT_RATE = (0.2, 0.8)          # the range its SSD hit rate must land in
LONG_CTX = 8192                    # the long-context decode timing, tokens per sequence
LONG_S8_L = 4096                   # the s8 probe's second timed length (its LONG_L)
# |got - want| <= ATOL + RTOL[dtype] * |want| elementwise. Both sides compute
# in fp32 and round the output once; 2^-7 |x| bounds one bf16 ulp at x.
ATOL = 1e-4
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


CARD = "not read"   # nvidia-smi's name and power limit, read by phase_env


def emit(phase: str, **fields):
    """One JSON line of a phase, with the card's name and power limit."""
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one fn() call, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each: on the main path every
    layer's attention finds its KV cold (the layer's weights streamed
    through L2 since its previous step). A spin kernel first holds the
    stream while the host enqueues every call, so the events time the
    device's work and not the host's launch gaps."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's ~2 GHz clock
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call over grouped K/V (q [N, Hq, L, hd],
    k/v [N, Hkv, C, hd], mask [N, 1, L, C] bool)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def _kernel_resources(lib) -> dict:
    """Registers, spills and shared memory of each instantiation of the
    split-KV paged kernels (csrc/paged_split.cuh), the tree kernels
    (csrc/tree_split.cuh, shared memory at the port's TREE_CHUNK), K1's
    bf16 kernel, K6's two bf16 routes and K9's, from ptxas's report of
    the build and the kernels' own shared-memory layouts."""
    import re

    from ssd_tpu_torch.ops import attention as att

    kinds = {0: "fp", 1: "int8", 2: "int8_mxu"}
    stages = {0: "full", 1: "loads", 2: "math", 3: "empty"}
    out = {"paged_split": [], "tree_split": [], "flat_prefill_tc": [], "grouped_gemm_wgmma": [],
           "int8_linear": []}
    cur = None
    for ln in lib.build_log.splitlines():
        if "Compiling entry" in ln:
            cur = None
            m = re.search(r"(paged|tree)_split_kernelI(13__nv_bfloat16|f)((?:Li\d+E)+)Lb([01])E", ln)
            if m:
                dt = "bfloat16" if m.group(2) != "f" else "float32"
                ints = [int(x) for x in re.findall(r"Li(\d+)E", m.group(3))]
                if m.group(1) == "paged":
                    hd, mt, kind, stage = ints
                    cur = {"row_tiles": mt, "stage": stages[stage],
                           "smem_bytes": lib.cdll.ssd_paged_smem_bytes(kind, int(dt == "bfloat16"), hd, mt)}
                else:
                    hd, kind = ints
                    chunk = att.TREE_CHUNK[(hd, kind != 0)]
                    cur = {"chunk": chunk, "smem_bytes": lib.cdll.ssd_tree_smem_bytes(
                        kind, int(dt == "bfloat16"), hd, chunk)}
                cur = {"dtype": dt, "hd": hd, "padded": m.group(4) == "1", "cache": kinds[kind],
                       **cur}
                out[f"{m.group(1)}_split"].append(cur)
            m = re.search(r"flat_prefill_tc_kernelI(13__nv_bfloat16|a)Li(\d+)ELb([01])E", ln)
            if m:
                int8, hd = m.group(1) == "a", int(m.group(2))
                cur = {"dtype": "bfloat16", "hd": hd, "padded": m.group(3) == "1",
                       "cache": "int8" if int8 else "fp",
                       "smem_bytes": lib.cdll.ssd_flat_prefill_smem_bytes(int(int8), hd)}
                out["flat_prefill_tc"].append(cur)
            m = re.search(r"grouped_gemm_wgmma_(decode_)?kernel", ln)
            if m:
                decode = m.group(1) is not None
                cur = {"route": "decode" if decode else "prefill",
                       "smem_bytes": lib.cdll.ssd_grouped_gemm_smem_bytes(int(decode))}
                out["grouped_gemm_wgmma"].append(cur)
            m = re.search(r"w8a16_wgmma_kernelI\w*?CfgILi(\d+)ELi(\d+)ELb([01])ELi(\d+)"
                          r"ELb([01])ELi(\d+)E", ln)
            if m:
                bn, wg, alt, ring, split, blocks = (int(m.group(i)) for i in range(1, 7))
                route = 1 if split else 2
                cur = {"route": ("decode", "prefill")[route - 1],
                       "tile": f"{64 if alt else 64 * wg} columns x {bn} rows, K stage 64",
                       "warpgroups": f"{wg}" + (", alternate stages" if alt else ""),
                       "stages": ring, "min_blocks_per_sm": blocks,
                       "groups": "several" if bn == 192 else "one or several" if split else "one",
                       "smem_bytes": lib.cdll.ssd_int8_linear_smem_bytes(
                           route, bn, 2 if bn == 192 else 1)}
                out["int8_linear"].append(cur)
            if "w8_f32_kernel" in ln:
                cur = {"route": "simt", "tile": "64x64, K slice 16", "smem_bytes": "static"}
                out["int8_linear"].append(cur)
        elif cur is not None and "spill stores" in ln:
            cur["spill"] = ln.split("stack frame, ")[-1].strip()
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            cur = None
    return out


def phase_env() -> dict:
    global CARD
    import torch

    from ssd_tpu_torch.ops import cuda_lib

    card = CARD = name_and_power_limit()
    print(card, flush=True)
    lib = cuda_lib.load()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    # Each source's nvcc seconds from the build's start ("== <source> (<s> s)").
    import re

    source_seconds = {m.group(1): float(m.group(2)) for m in
                      re.finditer(r"^== (.+) \(([\d.]+) s\)$", lib.build_log, re.M)}
    # The wrappers pick the tree kernels' chunk from a mirror of their
    # shared-memory layout (ops/attention.py::tree_smem_bytes): it must
    # agree with the kernels' own at every padded width.
    from ssd_tpu_torch.ops import attention as att

    for hp in (64, 128, 192, 256):
        for kind in (0, 1, 2):
            for dtype, q_bytes in ((0, 4), (1, 2)):
                for chunk in (64, 128, 256):
                    mine = att.tree_smem_bytes(hp, kind, q_bytes, chunk)
                    theirs = lib.cdll.ssd_tree_smem_bytes(kind, dtype, hp, chunk)
                    if mine != theirs:
                        fail(f"env: tree_smem_bytes(hd {hp}, kind {kind}, q {q_bytes} bytes, "
                             f"chunk {chunk}) = {mine}, the kernel's layout {theirs}")
    emit("env", card=card, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_seconds=lib.build_seconds,
         library=os.path.relpath(lib.path), source_seconds=source_seconds, ptxas=ptxas,
         **_kernel_resources(lib),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return {"card": card}


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def _paged_case(B, Q, ctx_lens, M, ghosts, dtype, seed, heads=LLAMA_HEADS):
    """Random q and cache, disjoint shuffled page tables; `ghosts` trailing
    rows are batch padding (context 1, table all -1). `heads` is (Hq, Hkv,
    hd)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    Hq, Hkv, hd = heads
    n_pages = B * M + 1
    kv = torch.randn(Hkv, n_pages * BLOCK, 2 * hd, generator=g)
    q = torch.randn(B, Q, Hq, hd, generator=g)
    perm = torch.randperm(n_pages, generator=g)
    bt = torch.full((B, M), -1, dtype=torch.int32)
    ctx = torch.ones(B, dtype=torch.int32)
    for b in range(B - ghosts):
        ctx[b] = ctx_lens[b]
        n = min(-(-ctx_lens[b] // BLOCK), M)
        bt[b, :n] = perm[b * M: b * M + n].to(torch.int32)
    qeff = torch.full((B,), Q, dtype=torch.int32)
    dev = "cuda"
    return (q.to(dev, dtype), kv.to(dev, dtype), bt.to(dev), ctx.to(dev),
            qeff.to(dev))


def _flat_case(ctx_lens, cached, dtype, seed, pad_rows=0, pad_pages=0,
               heads=LLAMA_HEADS):
    """Mixed prefill batch: sequence s has ctx_lens[s] tokens of which
    cached[s] are already in the cache; its pages form one run of the flat
    page list, and each new token's window is an interval of that run. The
    serving path passes no padding; `pad_rows` rows with lo == hi and
    `pad_pages` -1 pages check the kernel's padding contract."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    Hq, Hkv, hd = heads
    pages_per = [-(-c // BLOCK) for c in ctx_lens]
    n_pages = sum(pages_per) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    T = sum(c - k for c, k in zip(ctx_lens, cached))
    T_pad, P_pad = T + pad_rows, sum(pages_per) + pad_pages
    lo = np.zeros(T_pad, np.int32)
    hi = np.zeros(T_pad, np.int32)
    pages = np.full(P_pad, -1, np.int32)
    t = p = 0
    for c, k, n in zip(ctx_lens, cached, pages_per):
        pages[p:p + n] = perm[p:p + n]
        lo[t:t + c - k] = p * BLOCK
        hi[t:t + c - k] = p * BLOCK + np.arange(k, c) + 1
        t += c - k
        p += n
    q = rng.standard_normal((T_pad, Hq, hd)).astype(np.float32)
    kv = rng.standard_normal((Hkv, n_pages * BLOCK, 2 * hd)).astype(np.float32)
    dev = "cuda"
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(kv).to(dev, dtype),
            torch.from_numpy(pages).to(dev), torch.from_numpy(lo).to(dev),
            torch.from_numpy(hi).to(dev), T)


def _tree_case(B, step, bases, ghosts, dtype, seed, heads=LLAMA_HEADS):
    """One tree step s of the async draft at K=4, fan-out 2: sequence b's
    recovery token sits at bases[b], so its context is bases[b] + (K+1) +
    (s+1)*MQ. Even rows take the hit fan-out list [2]*5, odd rows a miss
    list [3, 3, 2, 1, 1]; `ghosts` trailing rows are warm-up ghosts (table
    all -1, a prefix of -3). Returns (q, kv, tables, contexts, fan rows)."""
    import numpy as np
    import torch

    M = SPEC_MAX_LEN // BLOCK
    ctx_lens = [b + SPEC_K + 1 + (step + 1) * SPEC_MQ for b in bases]
    q, kv, bt, ctx, _ = _paged_case(B, SPEC_MQ, ctx_lens, M, ghosts, dtype, seed, heads)
    ctx[B - ghosts:] = SPEC_K + 1 + (step + 1) * SPEC_MQ - 3
    hit = np.repeat(np.arange(SPEC_K + 1), [SPEC_F] * (SPEC_K + 1))
    miss = np.repeat(np.arange(SPEC_K + 1), [3, 3, 2, 1, 1])
    fan = np.stack([hit if b % 2 == 0 else miss for b in range(B)]).astype(np.int32)
    return q, kv, bt, ctx, torch.from_numpy(fan).cuda()


def _int8_pair(kv):
    """The cache layer kv [Hkv, S, 2hd] quantized by store_kv into the int8
    pair (data int8 [Hkv, S, 2hd], scales f32 [Hkv, 2, S]), on the card."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    x = kv.transpose(0, 1)                                      # [S, Hkv, 2hd]
    pair = (torch.zeros(Hkv, S, hd2, dtype=torch.int8, device=kv.device),
            torch.full((Hkv, 2, S), 1e-10, device=kv.device))
    att.store_kv(pair, x[..., :hd], x[..., hd:],
                 torch.arange(S, dtype=torch.int32, device=kv.device))
    return pair


def _check(name, dtype, got, want, case):
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name} {case} {dtype}: non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # The worst element's error over its own tolerance; <= 1 passes.
    excess = (diff / (ATOL + RTOL[dtype] * want.float().abs())).max().item()
    emit("kernels", kernel=name, case=case, dtype=dtype, max_abs_err=err,
         atol=ATOL, rtol=RTOL[dtype], worst_err_over_tol=excess, ok=excess <= 1)
    if not excess <= 1:
        fail(f"{name} {case} {dtype}: max abs err {err}, worst element at "
             f"{excess} x its tolerance ({ATOL} + {RTOL[dtype]} |ref|)")
    return err


def _timing(shape, fn, plain_fn, library_fn, bytes_, ops, peak, iters=50,
            plain_iters=10, library_iters=None):
    """One kernel's times at one shape: the kernel, its plain version, the
    library yardstick, and the bound (bytes over the HBM rate or operations
    over `peak`, whichever is larger)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / peak
    return dict(shape=shape, ms=time_ms(fn, iters),
                plain_ms=time_ms(plain_fn, plain_iters, warmup=1),
                library_ms=(time_ms(library_fn, library_iters or iters, warmup=1)
                            if library_fn else None),
                bytes=bytes_, flops=ops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _moe_offsets(tokens: int, seed: int):
    """Group offsets [E+1] of `tokens` tokens' top-k experts at the
    Qwen3-30B-A3B geometry, from a seeded random router over random hidden
    states (the last expert masked out, so at least one group is empty), on
    the card: the grouped GEMM's N = tokens * k rows."""
    import torch

    from ssd_tpu_torch.ops import moe
    from ssd_tpu_torch.ops.spec_math import stable_topk_indices

    c = QWEN3_30B_A3B
    E, k, D = c["num_experts"], c["num_experts_per_tok"], c["hidden_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, D, generator=g, device="cuda")
    logits = x @ (torch.randn(D, E, generator=g, device="cuda") * 0.02)
    logits[:, E - 1] = float("-inf")
    return moe.expert_offsets(stable_topk_indices(logits, k).reshape(-1), E)


def _gmm_case(offs, K: int, Nout: int, dtype, seed: int):
    """Random rows x [N, K] (N = offs[-1]) and experts w [E, K, Nout] at the
    init scale 0.02, on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    N, E = int(offs[-1]), offs.numel() - 1
    x = torch.randn(N, K, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, K, Nout, generator=g, device="cuda") * 0.02).to(dtype)
    return x, w


def _grouped_mm_yardstick(x, w, offs, want):
    """The library yardstick of the grouped GEMM, never called by the port:
    torch._grouped_mm over the same groups where this torch has it and takes
    the operands (w as stored, else a column-major copy), checked against
    the plain version; else one dense matmul of the same operations
    (x @ w[0]). Returns (callable, label)."""
    import torch

    why = "torch has no _grouped_mm"
    if hasattr(torch, "_grouped_mm"):
        ends = offs[1:].contiguous()
        for label, wt in (("torch._grouped_mm", w),
                          ("torch._grouped_mm (w column-major)",
                           w.transpose(1, 2).contiguous().transpose(1, 2))):
            try:
                y = torch._grouped_mm(x, wt, offs=ends)
                torch.cuda.synchronize()
            except RuntimeError as e:
                why = f"torch._grouped_mm refused: {str(e)[:160]}"
                continue
            tol = ATOL + RTOL["bfloat16"] * want.float().abs()
            if bool(((y.float() - want.float()).abs() <= 2 * tol).all()):
                return (lambda: torch._grouped_mm(x, wt, offs=ends)), label
            why = f"{label} disagrees with the plain version"
    w0 = w[0]
    return (lambda: x @ w0), f"dense torch.matmul x @ w[0], the same operations ({why})"


def _sdpa_paged(q, kv_layer, bt, ctx, Q, C, dt):
    """The yardstick's inputs for a paged case: q [B, Hq, Q, hd] and the
    context gathered dense (dequantized for the int8 pair) in q's dtype,
    with the causal mask; the port never calls it."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    k, v = att.gather_pages(kv_layer, bt, BLOCK, C)            # [B, C, Hkv, hd]
    k = k.to(dt).permute(0, 2, 1, 3).contiguous()
    v = v.to(dt).permute(0, 2, 1, 3).contiguous()
    qs = q.permute(0, 2, 1, 3).contiguous()
    rows = torch.arange(Q, device="cuda")[None, :]
    per_row = torch.clamp(ctx[:, None].long() - Q + rows + 1, min=0, max=C)
    pos = torch.arange(C, device="cuda")[None, None, :]
    mask = ((pos < per_row[:, :, None]) & (pos < ctx[:, None, None]))[:, None]
    return lambda: sdpa(qs, k, v, mask)


def _paged_work(q, ctx, bt, Q, C, Hkv, pos_bytes, elem):
    """(bytes, operations) of a paged call: each attended K|V position read
    once (pos_bytes per position and KV head, scales included), q read and
    the output written once, the tables and lengths read once; 4 * hd
    operations per (query head, attended position)."""
    import torch

    B, _, Hq, hd = q.shape
    rows = torch.arange(Q, device="cuda")[None, :]
    per_row = torch.clamp(ctx[:, None].long() - Q + rows + 1, min=0, max=C)
    kv_len = torch.clamp(ctx, max=C).long()
    bytes_ = (int(kv_len.sum()) * Hkv * pos_bytes + 2 * q.numel() * elem
              + bt.numel() * 4 + 2 * ctx.numel() * 4)
    return bytes_, 4 * Hq * hd * int(per_row.sum())


def _bmm_yardstick(qb, kb, want):
    """The bf16 dot's library yardstick, never called by the port: one
    torch.bmm of q by the bf16 copy of k (the cast is not timed), with fp32
    output where this torch takes out_dtype. Returns (callable, label)."""
    import torch

    kt = kb.transpose(1, 2)
    try:
        y = torch.bmm(qb, kt, out_dtype=torch.float32)
        if torch.equal(y.double(), want.double()):
            return (lambda: torch.bmm(qb, kt, out_dtype=torch.float32)), \
                "torch.bmm(q, bf16 k^T, out_dtype=float32)"
    except (TypeError, RuntimeError):
        pass
    return (lambda: torch.bmm(qb, kt)), "torch.bmm(q, bf16 k^T), bf16 output"


# K9's shapes: (case, M, N, K, groups or None, output dtype of a bf16 x).
# Llama-3.2-1B's projections (q and o share 2048 x 2048; k and v 512 x 2048)
# at the AR b8 decode (8 rows), the SD verify (40), the SSD tree step (80)
# and the decode route's widest x tile (128), its LM head at 8 and 80 rows
# (fp32 out), the serve prompts' prefill (5534 rows) at gate/up and down;
# Qwen3-30B-A3B's expert gate and down at a b8 decode dispatch (64 rows over
# 53 experts) and at b1 (8 one-row groups), groups from _moe_offsets'
# seeded router.
def _int8_linear_cases():
    c1, cq = LLAMA_1B, QWEN3_30B_A3B
    D, I, V = c1["hidden_size"], c1["intermediate_size"], c1["vocab_size"]
    Hkv_hd = c1["num_key_value_heads"] * c1["head_dim"]
    cases = []
    for m in (8, 40, 80, 128):
        cases += [(f"qo_m{m}", m, D, D, None, "bfloat16"),
                  (f"kv_m{m}", m, Hkv_hd, D, None, "bfloat16"),
                  (f"gate_up_m{m}", m, I, D, None, "bfloat16"),
                  (f"down_m{m}", m, D, I, None, "bfloat16")]
    cases += [(f"lm_head_m{m}", m, V, D, None, "float32") for m in (8, 80)]
    n = sum(SERVE_LENS8)
    cases += [(f"prefill_gate_up_m{n}", n, I, D, None, "bfloat16"),
              (f"prefill_down_m{n}", n, D, I, None, "bfloat16")]
    Dq, Im = cq["hidden_size"], cq["moe_intermediate_size"]
    for name, tokens, seed in (("moe_decode_b8", 8, 2), ("moe_decode_b1", 1, 3)):
        cases += [(f"{name}_gate", None, Im, Dq, (tokens, seed), "bfloat16"),
                  (f"{name}_down", None, Dq, Im, (tokens, seed), "bfloat16")]
    # One rank of Llama-3.1-70B at tp 4: the b8 decode (8 rows) and verify
    # (40), and the rank's vocabulary slice of the LM head.
    t = L70B_TP4
    for m in (8, 40):
        cases += [(f"l70b_tp4_q_m{m}", m, t["q"], t["D"], None, "bfloat16"),
                  (f"l70b_tp4_kv_m{m}", m, t["kv"], t["D"], None, "bfloat16"),
                  (f"l70b_tp4_o_m{m}", m, t["D"], t["q"], None, "bfloat16"),
                  (f"l70b_tp4_gate_up_m{m}", m, t["ffn"], t["D"], None, "bfloat16"),
                  (f"l70b_tp4_down_m{m}", m, t["D"], t["ffn"], None, "bfloat16"),
                  (f"l70b_tp4_lm_head_m{m}", m, t["vocab"], t["D"], None, "float32")]
    return cases


# The shared-x launch's products (ops/linear.py::int8_linear_shared): case,
# M, the outputs' widths, K, groups. q/k/v and gate/up over the same x at
# the dense cases' row counts and the prefill, the experts' gate/up at the
# b8 and b1 dispatches.
def _int8_shared_cases():
    c1, cq = LLAMA_1B, QWEN3_30B_A3B
    D, I = c1["hidden_size"], c1["intermediate_size"]
    Hkv_hd = c1["num_key_value_heads"] * c1["head_dim"]
    cases = []
    for m in (8, 40, 80, 128):
        cases += [(f"qkv_m{m}", m, (D, Hkv_hd, Hkv_hd), D, None),
                  (f"gate_up_pair_m{m}", m, (I, I), D, None)]
    cases += [(f"prefill_qkv_m{sum(SERVE_LENS8)}", sum(SERVE_LENS8), (D, Hkv_hd, Hkv_hd), D, None)]
    Dq, Im = cq["hidden_size"], cq["moe_intermediate_size"]
    cases += [(f"{name}_gate_up", None, (Im, Im), Dq, (tokens, seed))
              for name, tokens, seed in (("moe_decode_b8", 8, 2), ("moe_decode_b1", 1, 3))]
    return cases


def _int8_weights(g, G, N, K):
    import torch

    w = torch.randint(-127, 128, (G, N, K), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand(G, N, generator=g, device="cuda") * (0.04 / 127) + 0.01 / 127
    return w, s


def _replay_equals_eager(fn) -> bool:
    """fn()'s outputs from a CUDA graph replay against an eager call, bit for
    bit (the split-K sum order)."""
    import torch

    eager = fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    eager = eager if isinstance(eager, list) else [eager]
    captured = captured if isinstance(captured, list) else [captured]
    return all(torch.equal(a, b) for a, b in zip(eager, captured))


def _int8_linear_kernels(record) -> dict:
    """K9 against its plain version at every _int8_linear_cases() shape: bf16
    x (the case's output dtype) on each wgmma route forced in turn (decode,
    prefill), two calls bit-equal, and fp32 x (fp32 output, the SIMT route);
    then timed in bf16 on the rule's route beside its bound, the plain
    version, torch._weight_int8pack_mm (where it runs on the card for the
    shape) and, labelled, the bf16 product on the dequantized weight that
    the int8 path must beat (torch.matmul; torch._grouped_mm for the
    experts), neither of which the port calls. Then the shared-x launch at
    _int8_shared_cases(): one launch, each output bit for bit its own
    int8_linear call on the launch's route and within tolerance of the
    plain version, timed against those calls; and a CUDA graph replay of a
    split-K call, of the shared-x launch and of an expert call bit for bit
    their eager calls. Returns {case: timing}."""
    import torch

    from ssd_tpu_torch.ops import linear

    out = {}
    rule = linear.int8_linear_route
    for i, (case, M, N, K, groups, odt_name) in enumerate(_int8_linear_cases()):
        offs = None if groups is None else _moe_offsets(*groups)
        G = 1 if offs is None else offs.numel() - 1
        M = M if offs is None else int(offs[-1])
        g = torch.Generator(device="cuda").manual_seed(70 + i)
        x32 = torch.randn(M, K, generator=g, device="cuda")
        w, s = _int8_weights(g, G, N, K)
        odt = getattr(torch, odt_name)
        x = x32.to(torch.bfloat16)
        want = linear.int8_linear_plain(x, w, s, odt, offs)
        for route in ("decode", "prefill"):
            linear.int8_linear_route = lambda *shape, r=route: r
            try:
                got = linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs)
                again = linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs)
                torch.cuda.synchronize()
            finally:
                linear.int8_linear_route = rule
            # The tolerance of the output's dtype: fp32 sums of exact
            # products (an int8 value times a bf16 or fp32 one), rounded once.
            record("int8_linear", f"{case}[x bf16, {route}]", odt_name, got, want)
            if not torch.equal(got, again):
                fail(f"int8_linear {case} {route}: two calls differ")
        del got, again, want
        got = linear.int8_linear(x32, w, s, out_dtype=torch.float32, group_offsets=offs)
        torch.cuda.synchronize()
        record("int8_linear", f"{case}[x fp32]", "float32", got,
               linear.int8_linear_plain(x32, w, s, torch.float32, offs))
        del x32, got
        active = G if offs is None else int((offs[1:] > offs[:-1]).sum())
        bytes_ = (M * K * 2 + active * N * (K + 4) + M * N * odt.itemsize
                  + (0 if offs is None else offs.numel() * 4))
        library, label, bf16_fn, bf16_label = _int8_library(x, w, s, offs, odt)
        tm = _timing(f"{case}: M={M}" + ("" if offs is None else f" over {active} of {G} "
                                           "experts") + f", K={K} -> N={N}, bf16 x, "
                     f"{odt_name} out, route {rule(x.dtype, M, N, G)}",
                     lambda: linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=offs),
                     lambda: linear.int8_linear_plain(x, w, s, odt, offs),
                     library, bytes_, 2 * M * N * K, PEAK_FLOPS["bfloat16"],
                     iters=10 if M > 1000 else 30, plain_iters=3,
                     # torch._weight_int8pack_mm takes 5-200 ms at the head and prefill
                     library_iters=3 if N * M > 2 ** 22 else None)
        tm["library"] = label
        tm["route"] = rule(x.dtype, M, N, G)
        tm["bf16_ms"] = time_ms(bf16_fn, 10 if M > 1000 else 30)
        tm["bf16"] = bf16_label
        out[case] = tm
        emit("kernels", kernel="int8_linear", case=case, timing=tm)
        del x, w, s, library, bf16_fn
    out.update(_int8_shared_kernels(record))
    return out


def _int8_shared_kernels(record) -> dict:
    """The shared-x launch and the graph replays of _int8_linear_kernels."""
    import torch

    from ssd_tpu_torch.ops import linear

    out = {}
    for i, (case, M, Ns, K, groups) in enumerate(_int8_shared_cases()):
        offs = None if groups is None else _moe_offsets(*groups)
        G = 1 if offs is None else offs.numel() - 1
        M = M if offs is None else int(offs[-1])
        g = torch.Generator(device="cuda").manual_seed(90 + i)
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        pairs = [_int8_weights(g, G, N, K) for N in Ns]
        ws, ss = [p[0] for p in pairs], [p[1] for p in pairs]
        shared = lambda: linear.int8_linear_shared(x, ws, ss, group_offsets=offs)
        route = linear.int8_linear_route(x.dtype, M, Ns[0], G)   # the first product's

        def separate():   # each product alone, on the shared launch's route
            rule, linear.int8_linear_route = linear.int8_linear_route, lambda *shape: route
            try:
                return [linear.int8_linear(x, w, s, group_offsets=offs) for w, s in zip(ws, ss)]
            finally:
                linear.int8_linear_route = rule

        n0 = linear.int8_linear.launches
        got = shared()
        launches = linear.int8_linear.launches - n0
        sep = separate()
        torch.cuda.synchronize()
        if launches != 1:
            fail(f"int8_linear_shared {case}: {launches} launches, not 1")
        for j, (a, b, w, s) in enumerate(zip(got, sep, ws, ss)):
            record("int8_linear", f"{case}[shared {j}]", "bfloat16", a,
                   linear.int8_linear_plain(x, w, s, torch.bfloat16, offs))
            if not torch.equal(a, b):
                fail(f"int8_linear_shared {case}: output {j} differs from its own call")
        del got, sep
        tm = {"shape": f"{case}: M={M}, K={K} -> N={list(Ns)}" + ("" if offs is None else
                                                                 f" over the experts of {G}"),
              "route": route,
              "shared_ms": time_ms(shared, 10 if M > 1000 else 30),
              "separate_ms": time_ms(separate, 10 if M > 1000 else 30)}
        if case in ("qkv_m8", "moe_decode_b8_gate_up"):
            tm["replay_equals_eager"] = _replay_equals_eager(shared)
            if not tm["replay_equals_eager"]:
                fail(f"int8_linear_shared {case}: graph replay differs from eager")
        out[case] = tm
        emit("kernels", kernel="int8_linear", shared_case=case, timing=tm)
        del x, ws, ss
    # A split-K call on its own (down: K 8192 in 8 splits at 80 rows).
    g = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(80, LLAMA_1B["intermediate_size"], generator=g,
                    device="cuda").to(torch.bfloat16)
    w, s = _int8_weights(g, 1, LLAMA_1B["hidden_size"], LLAMA_1B["intermediate_size"])
    if not _replay_equals_eager(lambda: linear.int8_linear(x, w, s)):
        fail("int8_linear down_m80: graph replay differs from eager")
    return out


def _int8_library(x, w, s, offs, odt):
    """K9's yardsticks, never called by the port: one
    torch._weight_int8pack_mm call (bf16 x, int8 [N, K], bf16 scales) where
    it runs on the card for a dense shape (else the bf16 product below), and
    the bf16 product over the dequantized weight (torch.matmul;
    torch._grouped_mm, or a dense matmul of the same operations, for the
    experts): what the int8 path must beat to pay. Returns (library,
    label, bf16 product, label)."""
    import torch

    if offs is None:
        w0, s0 = w[0], s[0].to(torch.bfloat16)
        wd = (w0.float() * s[0][:, None]).to(torch.bfloat16).T
        bf16 = (lambda: torch.matmul(x, wd)), "bf16 torch.matmul on the dequantized weight"
        try:
            y = torch._weight_int8pack_mm(x, w0, s0)
            torch.cuda.synchronize()
            if y.shape == (x.shape[0], w0.shape[0]):
                return (lambda: torch._weight_int8pack_mm(x, w0, s0)), \
                    "torch._weight_int8pack_mm", *bf16
            why = f"torch._weight_int8pack_mm gave shape {tuple(y.shape)}"
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            why = f"torch._weight_int8pack_mm refused: {str(e)[:120]}"
        return bf16[0], f"{bf16[1]} ({why})", *bf16
    wd = (w.float() * s[..., None]).to(torch.bfloat16).transpose(1, 2).contiguous()
    want = (torch.cat([x[a:b].float() @ wd[e].float() for e, (a, b) in
                       enumerate(zip(offs[:-1].tolist(), offs[1:].tolist()))])
            .to(torch.bfloat16))
    fn, label = _grouped_mm_yardstick(x, wd, offs, want)
    label = f"{label} on the dequantized bf16 experts"
    return fn, label, fn, label


def _paged_batch_invariance(decode_ctx: list[int]):
    """The split-KV paged kernels' promise, bit for bit in bf16 over the fp
    cache and both int8 modes, at Llama-3.2-1B's and Qwen3-30B-A3B's heads:
    a call repeated gives the same bits; each sequence's rows alone equal
    its rows in the batch of 8; a Q=1 call equals query 0 of a Q=K+1 call
    whose contexts hold the K later queries (the same causal limit)."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    Q = SPEC_K + 1
    M = SPEC_MAX_LEN // BLOCK
    ctx_lens = [n + Q for n in decode_ctx]
    checked = []
    for heads in (LLAMA_HEADS, QWEN_HEADS):
        scale = heads[2] ** -0.5
        q, kv, bt, ctx, qeff = _paged_case(8, Q, ctx_lens, M, 0, torch.bfloat16, seed=71,
                                           heads=heads)
        pair = _int8_pair(kv)
        for name, layer, s8 in (("paged_attention", kv, False),
                                ("paged_attention_int8", pair, False),
                                ("paged_attention_int8[s8]", pair, True)):
            full = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8)
            same = torch.equal(full, att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale,
                                                         s8=s8))
            for b in range(8):
                alone = att.paged_attention(q[b:b + 1], layer, bt[b:b + 1], ctx[b:b + 1],
                                            qeff[:1], BLOCK, scale, s8=s8)
                same = same and torch.equal(alone[0], full[b])
            one = att.paged_attention(q[:, :1].contiguous(), layer, bt, ctx - (Q - 1),
                                      torch.ones_like(qeff), BLOCK, scale, s8=s8)
            same = same and torch.equal(one[:, 0], full[:, 0])
            checked.append(f"{name} hd {heads[2]} G {heads[0] // heads[1]}")
            if not same:
                fail(f"{name} at heads {heads}: not batch-invariant bit for bit")
    emit("kernels", batch_invariance={"bitwise": True, "checked": checked})


def _flat_batch_invariance():
    """K1's bf16 kernel over the fp cache and the int8 pages, at the
    serving block size 64, bit for bit: each of the serve prompts run alone
    (its own pages, columns from 0) equals its rows in the batch of 8, at
    the Llama-3.2-1B heads (hd 64, G 4) and Qwen3-30B-A3B's (hd 128, G 8)."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    checked = 0
    for seed, heads in enumerate((LLAMA_HEADS, QWEN_HEADS)):
        q, kv, pages, lo, hi, T = _flat_case(SERVE_LENS8, [0] * 8, torch.bfloat16,
                                             seed=90 + seed, heads=heads)
        s = heads[2] ** -0.5
        for layer in (kv, _int8_pair(kv)):
            full = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, s)
            off = p = 0
            for n in SERVE_LENS8:
                npages = -(-n // BLOCK)
                alone = att.flat_prefill_attention(
                    q[off:off + n].contiguous(), layer, pages[p:p + npages].contiguous(),
                    torch.zeros(n, dtype=torch.int32, device="cuda"),
                    torch.arange(1, n + 1, dtype=torch.int32, device="cuda"), BLOCK, s)
                if not torch.equal(alone, full[off:off + n]):
                    fail(f"flat_prefill_attention: prompt of {n} tokens alone differs from "
                         f"its rows in the batch (heads {heads}, "
                         f"{'int8' if isinstance(layer, tuple) else 'fp'} cache)")
                off, p, checked = off + n, p + npages, checked + 1
    emit("kernels", kernel="flat_prefill_attention", batch_invariant=True,
         prompts_checked=checked, block_size=BLOCK)


def _probe_kernels(record, decode_ctx: list[int]) -> dict:
    """Rows #11 and #12 of the kernel table: the s8 probe's three paths
    exact against the fp64 plain version at s8_probe.CHECK_SHAPES and
    timed at bench/s8_probe.py's shape and at s8_probe.LONG_L positions; the
    paged kernels' stage variants (K2, and K4's int8 mode) at the decode b8
    batch and at B=8 x LONG_CTX, whose "full" stage must equal the
    production kernel bit for bit. Then both bench entry points run once
    (the probes' own path), with the probe launch counts zeroed just before
    and read just after each."""
    import torch

    from ssd_tpu_torch.bench import kernel_diag, s8_probe
    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import probes

    timings = {}
    no_lib = "none: torch._int_mm is 2-D; no single call takes a batched s8 product"
    paths = (("s8_dot_mma", probes.s8_dot_mma, PEAK_OPS_INT8),
             ("s8_dot_dp4a", probes.s8_dot_dp4a, PEAK_OPS_INT8),
             ("s8_dot_bf16", probes.s8_dot_bf16, PEAK_FLOPS["bfloat16"]))
    # Bit for bit at every shape of s8_probe.CHECK_SHAPES (the probe's, 4096
    # positions, one row block, D = 64, tails past the last whole block).
    for N, L, D in s8_probe.CHECK_SHAPES:
        q8, k8, qb = s8_probe.inputs("cuda", N=N, L=L, D=D)
        want = probes.s8_dot_plain(q8, k8)
        for name, fn, _ in paths:
            got = fn(qb if name == "s8_dot_bf16" else q8, k8)
            torch.cuda.synchronize()
            record(name, f"N{N}_L{L}_D{D}", "float32", got, want)
            if not torch.equal(got.double(), want.double()):
                fail(f"{name}: differs from its exact plain version at N={N}, L={L}, D={D}")
    emit("kernels", kernel="s8_probe", exact_at=[list(s) for s in s8_probe.CHECK_SHAPES])
    # Timed at the probe's shape and at LONG_L positions.
    for L in (s8_probe.SHAPE["L"], s8_probe.LONG_L):
        q8, k8, qb = s8_probe.inputs("cuda", L=L)
        want = probes.s8_dot_plain(q8, k8)
        N, R, D = q8.shape
        ops = 2 * N * R * L * D
        bmm, bmm_label = _bmm_yardstick(qb, k8.to(torch.bfloat16), want)
        for name, fn, peak in paths:
            q, bf16 = (qb, True) if name == "s8_dot_bf16" else (q8, False)
            out_bytes = N * R * L * 4
            bytes_ = q.numel() * q.element_size() + k8.numel() + out_bytes
            tm = _timing(f"q [{N}, {R}, {D}] {q.dtype} . k [{N}, {L}, {D}] int8 -> "
                         f"[{N}, {R}, {L}] {'float32' if bf16 else 'int32'}",
                         lambda fn=fn, q=q: fn(q, k8), lambda q=q: probes.s8_dot_plain(q, k8),
                         bmm if bf16 else None, bytes_, ops, peak, iters=50, plain_iters=5)
            tm["library"] = bmm_label if bf16 else no_lib
            if L == s8_probe.SHAPE["L"]:
                timings[name] = tm
            else:
                timings[name][f"at_l{L}"] = tm
            emit("kernels", kernel=name, timing=tm)
        del q8, k8, qb, bmm

    scale = 64 ** -0.5
    shapes = {"decode_b8": decode_ctx, f"b8_x_{LONG_CTX}": [LONG_CTX] * 8}
    for name, kvq in (("paged_attention_diag", None), ("paged_attention_int8_diag", "int8")):
        per_shape = {}
        for label, ctx_lens in shapes.items():
            q, layer, bt, ctx, qeff = kernel_diag.decode_case(
                8, 1, 32, 8, 64, BLOCK, ctx_lens, torch.bfloat16, kv_quant=kvq, seed=70)
            args = (q, layer, bt, ctx, qeff, BLOCK, scale)
            prod = att.paged_attention(*args)
            full = probes.paged_attention_diag("full", *args)
            torch.cuda.synchronize()
            record(name, label, "bfloat16", full, att.paged_attention_plain(*args))
            if not torch.equal(full, prod):
                fail(f"{name} {label}: the full stage differs from the production kernel")
            C = bt.shape[1] * BLOCK
            bytes_, ops_ = _paged_work(q, ctx, bt, 1, C, 8, 2 * 64 * 2 if kvq is None
                                       else 2 * 64 + 8, 2)
            tm = _timing(f"decode B=8 (ctx {ctx_lens if label == 'decode_b8' else '8 x %d' % LONG_CTX})"
                         f" Q=1 Hq/Hkv 32/8 hd 64 bf16" + (", int8 cache" if kvq else ""),
                         lambda: probes.paged_attention_diag("full", *args),
                         lambda: att.paged_attention_plain(*args),
                         _sdpa_paged(q, layer, bt, ctx, 1, C, torch.bfloat16), bytes_, ops_,
                         PEAK_FLOPS["bfloat16"], iters=20, plain_iters=3)
            tm["stages_ms"] = {st: time_ms(lambda st=st: probes.paged_attention_diag(st, *args), 20)
                               for st in probes.STAGES}
            # A split of the full time into loads and math is only read when
            # each stage alone takes no longer than the full kernel and the
            # two together no less.
            st = tm["stages_ms"]
            tm["stages_bracket_full"] = (max(st["dma"], st["compute"]) <= st["full"]
                                         <= st["dma"] + st["compute"])
            per_shape[label] = tm
            emit("kernels", kernel=name, stages=tm)
        timings[name] = dict(per_shape["decode_b8"], **{f"at_{k}": v for k, v in per_shape.items()
                                                       if k != "decode_b8"})

    # The probes' own path: their bench entry points, as `python -m` runs them.
    launches = {}
    ctx_arg = ",".join(map(str, decode_ctx))
    runs = (("s8", [], s8_probe.main, ["--iters", "20"]),
            ("paged_attention_diag", ["bf16"], kernel_diag.main, None),
            ("paged_attention_int8_diag", ["int8"], kernel_diag.main, None))
    for name, kv, main_fn, argv in runs:
        for w in probes.PROBE_WRAPPERS:
            w.launches = 0
        if argv is not None:
            main_fn(argv)
        else:
            for ctx_list in (ctx_arg, ",".join([str(LONG_CTX)] * 8)):
                main_fn(["--contexts", ctx_list, "--hd", "64", "--block", str(BLOCK),
                         "--iters", "20", "--kv", kv[0]])
        if name == "s8":
            launches.update({w.__name__: w.launches for w in probes.PROBE_WRAPPERS[:3]})
        else:
            launches[name] = probes.paged_attention_diag.launches
    emit("kernels", probe_launches=launches)
    return {"timings": timings, "launches": launches}


def _tree_timings(q, kv, bt, ctx, fan, label, heads) -> dict:
    """K3 and K5 (both int8 modes; the s8 one where JAX's router takes it)
    timed in bf16 at one tree step (the last, s = K-1) of the async draft:
    each attended K|V position read once (and
    its two scales for the int8 cache), q read and the output written once,
    the tables, contexts and fan rows read once; 4 * hd operations per
    (query head, attended position). The yardstick: SDPA over the gathered
    dense K/V (dequantized for the int8 cache) with the tree mask."""
    import torch

    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops.spec_math import tree_attention_mask

    Hq, Hkv, hd = heads
    step, dt, elem = SPEC_K - 1, torch.bfloat16, 2
    scale = hd ** -0.5
    C = bt.shape[1] * BLOCK
    mask = tree_attention_mask(ctx, step, fan, SPEC_K, SPEC_MQ, C)      # [B, MQ, C]
    kv_len = int(torch.clamp(ctx, max=C).long().sum())
    ops = 4 * Hq * hd * int(mask.sum())
    qs = q.permute(0, 2, 1, 3).contiguous()                             # [B, Hq, MQ, hd]
    pair = _int8_pair(kv)
    out = {}
    for name, mode in (("tree_attention", None), ("tree_attention_int8", "int8"),
                       ("tree_attention_int8[s8]", "int8_mxu")):
        layer = kv if mode is None else pair
        s8 = mode == "int8_mxu"
        if s8 and not att.takes_s8(hd, Hkv, SPEC_MQ * Hq // Hkv):
            continue   # int8_mxu runs the int8 kernel here, as JAX's router does
        pos_bytes = 2 * hd * elem if mode is None else 2 * hd + 8
        bytes_ = (kv_len * Hkv * pos_bytes + 2 * q.numel() * elem
                  + bt.numel() * 4 + ctx.numel() * 4 + fan.numel() * 4)
        args = (q, layer, bt, ctx, fan, step, SPEC_K, BLOCK, scale)
        k, v = att.gather_pages(layer, bt, BLOCK, C)                    # [B, C, Hkv, hd]
        k = k.to(dt).permute(0, 2, 1, 3).contiguous()
        v = v.to(dt).permute(0, 2, 1, 3).contiguous()
        out[name] = _timing(
            f"tree step {step} of K={SPEC_K}, {label} (ctx {ctx.tolist()}) MQ={SPEC_MQ} "
            f"Hq/Hkv {Hq}/{Hkv} hd {hd} bf16" + ("" if mode is None else f", {mode} cache"),
            lambda: att.tree_attention(*args, s8=s8),
            lambda: att.tree_attention_plain(*args, s8=s8),
            lambda: sdpa(qs, k, v, mask[:, None]), bytes_, ops,
            PEAK_OPS_INT8 if s8 else PEAK_FLOPS["bfloat16"])
        del k, v
    return out


def _attention_times(heads: tuple, label: str, int8: bool = False) -> dict:
    """K2 at the b8 decode (Q=1), K1 at the prefill of the 8 serve prompts
    and K3/K5 (both int8 modes) at the b8 tree step, timed in bf16 at the
    heads (Hq, Hkv, hd) beside SDPA and their bounds; with int8, K4 at the
    decode and K1 over int8 pages too. Returns {kernel: timing}."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    M = 2048 // BLOCK
    serve8 = [n + 64 for n in SERVE_LENS8]
    out = {}
    Hq, Hkv, hd = heads
    dt, sc, elem = torch.bfloat16, hd ** -0.5, 2
    fp_pos = 2 * hd * elem
    q, kv, bt, ctx, qeff = _paged_case(8, 1, serve8, M, 0, dt, seed=114, heads=heads)
    bytes_, ops = _paged_work(q, ctx, bt, 1, M * BLOCK, Hkv, fp_pos, elem)
    out["paged_attention"] = _timing(
        f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv {Hq}/{Hkv} hd {hd} bf16 ({label})",
        lambda: att.paged_attention(q, kv, bt, ctx, qeff, BLOCK, sc),
        lambda: att.paged_attention_plain(q, kv, bt, ctx, qeff, BLOCK, sc),
        _sdpa_paged(q, kv, bt, ctx, 1, M * BLOCK, dt), bytes_, ops, PEAK_FLOPS["bfloat16"])
    if int8:
        pair = _int8_pair(kv)
        bytes_, ops = _paged_work(q, ctx, bt, 1, M * BLOCK, Hkv, 2 * hd + 8, elem)
        out["paged_attention_int8"] = _timing(
            f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv {Hq}/{Hkv} hd {hd} bf16, int8 cache ({label})",
            lambda: att.paged_attention(q, pair, bt, ctx, qeff, BLOCK, sc),
            lambda: att.paged_attention_plain(q, pair, bt, ctx, qeff, BLOCK, sc),
            _sdpa_paged(q, pair, bt, ctx, 1, M * BLOCK, dt), bytes_, ops, PEAK_FLOPS["bfloat16"])
        del pair
    q, kv, pages, lo, hi, T = _flat_case(SERVE_LENS8, [0] * 8, dt, seed=115, heads=heads)
    n_pages = sum(-(-n // BLOCK) for n in SERVE_LENS8)
    ops = int(4 * Hq * hd * (hi - lo).long().sum())
    col = torch.arange(n_pages * BLOCK, device="cuda")
    mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
    qs = q.permute(1, 0, 2)[None].contiguous()
    for name, layer, pos_bytes in (("flat_prefill_attention", kv, fp_pos),
                                   ("flat_prefill_attention_int8", _int8_pair(kv) if int8 else None,
                                    2 * hd + 8)):
        if layer is None:
            continue
        bytes_ = (n_pages * BLOCK * Hkv * pos_bytes + 2 * T * Hq * hd * elem
                  + pages.numel() * 4 + 2 * T * 4)
        dense = att.dense_pages(layer, pages, BLOCK).to(dt)
        kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
        out[name] = _timing(
            f"prefill 8 prompts {SERVE_LENS8}, nothing cached, T={T} Hq/Hkv {Hq}/{Hkv} hd {hd} "
            f"bf16{', int8 pages' if layer is not kv else ''} ({label})",
            lambda: att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, sc),
            lambda: att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, sc),
            lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS["bfloat16"], iters=10,
            plain_iters=3)
        del kd, vd, dense
    q, kv, bt, ctx, fan = _tree_case(8, SPEC_K - 1, serve8, 0, dt, seed=116, heads=heads)
    out.update(_tree_timings(q, kv, bt, ctx, fan, f"B=8 ({label})", heads))
    del q, kv
    return out


def _tp_kernels(record) -> dict:
    """The kernels at the shapes one rank of a tensor-parallel engine gives
    them: K1 (fp and int8 pages), K2 / K4 (both int8 modes) at the b8
    decode and verify, and K3 / K5 at the last tree step, at Llama-3.1-70B's
    per-rank heads (tp 4: 16/2, tp 8: 8/1, hd 128), in fp32 and bf16 against
    their plain versions, then timed in bf16 at tp 4 beside SDPA and their
    bounds; K6 and K9 over one expert-parallel rank's groups (Qwen3-30B-A3B
    at tp 2: rank 0's 64 experts of a b8 decode dispatch, the offsets ending
    at its rows, the other rank's rows past them not computed), the rows
    they own against the plain versions. Returns {kernel: timing}."""
    import torch

    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import linear, moe

    M, M_spec = 2048 // BLOCK, SPEC_MAX_LEN // BLOCK
    serve8 = [n + 64 for n in SERVE_LENS8]
    verify_ctx = [n + SPEC_K + 1 for n in serve8]
    flat_lens = [17, 100, 300, 600, 900, 1200, 1600, 2048]
    flat_cached = [0, 0, 0, 0, 512, 0, 0, 1024]
    modes = (("paged_attention", False, False), ("paged_attention_int8", True, False),
             ("paged_attention_int8[s8]", True, True))
    for label, heads in L70B_TP_HEADS.items():
        sc = heads[2] ** -0.5
        for dn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for i, (case, args) in enumerate((("decode_b8", (8, 1, serve8, M, 0)),
                                              ("verify_b8", (8, SPEC_K + 1, verify_ctx,
                                                             M_spec, 0)))):
                q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=110 + i, heads=heads)
                pair = _int8_pair(kv)
                for name, int8, s8 in modes:
                    layer = pair if int8 else kv
                    got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, sc, s8=s8)
                    torch.cuda.synchronize()
                    record(name, f"l70b_{label}_{case}", dn, got,
                           att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, sc, s8=s8))
            q, kv, pages, lo, hi, T = _flat_case(flat_lens, flat_cached, dt, seed=112,
                                                 pad_rows=13, pad_pages=3, heads=heads)
            for name, layer in (("flat_prefill_attention", kv),
                                ("flat_prefill_attention_int8", _int8_pair(kv))):
                got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, sc)
                torch.cuda.synchronize()
                record(name, f"l70b_{label}_mixed8_cached2", dn, got,
                       att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, sc))
            q, kv, bt, ctx, fan = _tree_case(8, SPEC_K - 1, serve8, 1, dt, seed=113, heads=heads)
            pair = _int8_pair(kv)
            for name, int8, s8 in modes:
                layer = pair if int8 else kv
                args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, sc)
                got = att.tree_attention(q, layer, *args, s8=s8)
                torch.cuda.synchronize()
                record(name.replace("paged", "tree"), f"l70b_{label}_tree_b8", dn, got,
                       att.tree_attention_plain(q, layer, *args, s8=s8))
            del q, kv, pair

    # Times at tp 4 in bf16.
    out = _attention_times(L70B_TP_HEADS["tp4"], "Llama-3.1-70B, tp 4")
    for name, tm in out.items():
        emit("kernels", kernel=name, llama31_70b_tp4=tm)

    # One expert-parallel rank's dispatch (rank 0 of 2 over Qwen3-30B-A3B's
    # 128 experts): K6 in both dtypes, K9 over int8 experts.
    c = QWEN3_30B_A3B
    D, Im, E = c["hidden_size"], c["moe_intermediate_size"], c["num_experts"]
    full = _moe_offsets(8, seed=2)                 # 64 rows over the 128 experts
    offs = full[:E // 2 + 1].contiguous()          # rank 0's groups, ending at its rows
    n = int(offs[-1])
    for dn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for case, K, Nout in (("gate", D, Im), ("down", Im, D)):
            g = torch.Generator(device="cuda").manual_seed(117)
            x = torch.randn(int(full[-1]), K, generator=g, device="cuda").to(dt)
            w = (torch.randn(E // 2, K, Nout, generator=g, device="cuda") * 0.02).to(dt)
            got = moe.grouped_gemm(x, w, offs)
            torch.cuda.synchronize()
            record("grouped_gemm", f"ep_rank0_of2_decode_b8_{case}", dn, got[:n],
                   moe.grouped_gemm_plain(x, w, offs)[:n])
            wq, s = _int8_weights(g, E // 2, Nout, K)
            got = linear.int8_linear(x, wq, s, group_offsets=offs)
            torch.cuda.synchronize()
            record("int8_linear", f"ep_rank0_of2_decode_b8_{case}", dn, got[:n],
                   linear.int8_linear_plain(x, wq, s, dt, offs)[:n])
    return out



def _head_dim_kernels(record) -> dict:
    """K1-K5 at every width of HEAD_DIM_WIDTHS against their plain versions,
    in fp32 and bf16: K2 and K4 at a decode and a verify (Q = K+1) of 4
    sequences with a ghost row, K1 over a mixed prefill with two cached
    prompts and padding rows and pages, K3 and K5 at the last tree step
    with a ghost row; the int8 cache's "int8" mode everywhere and its s8
    mode where JAX's router takes it (hd 192 and 256 here). Heads 8/8
    (G = 1) at hd 32, 80, 100 and 256, 8/2 (G = 4) at 48, 96 and 192.
    Then K1-K5 timed in bf16 at OpenLLaMA-3B's heads (32/32, hd 100) beside
    SDPA and their bounds. Returns {kernel: timing at hd 100}."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    M = 1024 // BLOCK
    modes = (("paged_attention", False, False), ("paged_attention_int8", True, False),
             ("paged_attention_int8[s8]", True, True))
    for i, hd in enumerate(HEAD_DIM_WIDTHS):
        heads = (8, 8, hd) if hd in (32, 80, 100, 256) else (8, 2, hd)
        Hq, Hkv, _ = heads
        sc, tag = hd ** -0.5, f"hd{hd}_g{Hq // Hkv}"
        for dn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for j, (case, args) in enumerate((("decode_b4", (4, 1, [1000, 1, 333], M, 1)),
                                              ("verify_b4", (4, SPEC_K + 1, [1024, SPEC_K + 1, 517],
                                                             M, 1)))):
                q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=200 + 10 * i + j, heads=heads)
                pair = _int8_pair(kv)
                for name, int8, s8 in modes:
                    if s8 and not att.takes_s8(hd, Hkv, q.shape[1] * Hq // Hkv):
                        continue
                    layer = pair if int8 else kv
                    got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, sc, s8=s8)
                    torch.cuda.synchronize()
                    record(name, f"{tag}_{case}", dn, got,
                           att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, sc, s8=s8))
            q, kv, pages, lo, hi, T = _flat_case([17, 300, 650, 129], [0, 0, 256, 64], dt,
                                                 seed=202 + 10 * i, pad_rows=5, pad_pages=2,
                                                 heads=heads)
            for name, layer in (("flat_prefill_attention", kv),
                                ("flat_prefill_attention_int8", _int8_pair(kv))):
                got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, sc)
                torch.cuda.synchronize()
                record(name, f"{tag}_mixed4_cached2", dn, got,
                       att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, sc))
                if got[T:].abs().max().item() != 0.0:
                    fail(f"{name} hd {hd}: padding rows are not zero")
            q, kv, bt, ctx, fan = _tree_case(4, SPEC_K - 1, [700, 0, 300], 1, dt,
                                             seed=203 + 10 * i, heads=heads)
            pair = _int8_pair(kv)
            for name, int8, s8 in modes:
                if s8 and not att.takes_s8(hd, Hkv, SPEC_MQ * Hq // Hkv):
                    continue
                name = name.replace("paged", "tree")
                layer = pair if int8 else kv
                args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, sc)
                got = att.tree_attention(q, layer, *args, s8=s8)
                torch.cuda.synchronize()
                record(name, f"{tag}_tree_b4_step{SPEC_K - 1}", dn, got,
                       att.tree_attention_plain(q, layer, *args, s8=s8))
            del q, kv, pair
    out = _attention_times(OPEN_LLAMA_HEADS, "OpenLLaMA-3B", int8=True)
    for name, tm in out.items():
        emit("kernels", kernel=name, open_llama_3b_hd100=tm)
    return out


def phase_kernels() -> dict:
    import torch

    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import moe

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    scale = 64 ** -0.5
    M = 2048 // BLOCK
    M_spec = SPEC_MAX_LEN // BLOCK
    decode8 = [2048, 1, 700, 1333, 64, 65, 1999]  # + one ghost row
    # SD/SSD verify and glue at Q = K+1 (G*Q = 20 rows per KV head: two full
    # 8-row passes and a partial one); contexts up to the spec engine's
    # table, down to Q itself, + one ghost row.
    verify8 = [SPEC_MAX_LEN, SPEC_K + 1, 700, 1333, 64, 65, 2047]
    # The serve phase's b8 batch halfway through its 128 decode steps.
    serve8 = [n + 64 for n in SERVE_LENS8]
    # decode at B = 1 and B = 8 (one ghost row), the overshoot case (a full
    # table with context beyond it, Q = 4), and the verify shape.
    paged_cases = {
        "decode_b1": (1, 1, [1500], M, 0),
        "decode_b8": (8, 1, decode8, M, 1),
        "overshoot_q4": (3, 4, [258, 100, 256], 4, 0),  # table holds 256
        "verify_b1": (1, SPEC_K + 1, [2090], M_spec, 0),
        "verify_b8": (8, SPEC_K + 1, verify8, M_spec, 1),
    }
    tree_cases = {"tree_b1": (1, [2048], 0),
                  "tree_b8": (8, [1500, 0, 700, 1333, 64, 65, 1999], 1)}
    flat_lens = [17, 100, 300, 600, 900, 1200, 1600, 2048]
    flat_cached = [0, 0, 0, 0, 512, 0, 0, 1024]
    c = QWEN3_30B_A3B
    D, Im = c["hidden_size"], c["moe_intermediate_size"]
    prefill_offs = _moe_offsets(sum(SERVE_LENS8), seed=1)   # N = 5534 * 8 rows
    decode_offs = _moe_offsets(8, seed=2)                   # N = 64 rows
    decode1_offs = _moe_offsets(1, seed=3)                  # N = 8 rows, one a group
    gmm_cases = {"prefill_gate": (prefill_offs, D, Im), "prefill_down": (prefill_offs, Im, D),
                 "decode_b8_gate": (decode_offs, D, Im), "decode_b8_down": (decode_offs, Im, D),
                 "decode_b1_gate": (decode1_offs, D, Im), "decode_b1_down": (decode1_offs, Im, D)}
    wrappers = _kernel_wrappers()
    results = {}

    def record(name, case, dname, got, want):
        results[(name, case, dname)] = {"max_abs_err": _check(name, dname, got, want, case)}

    for dname, dt in dts.items():
        # K-A (fp cache), then the int8 pair in both modes.
        for seed, (case, args) in enumerate(paged_cases.items()):
            q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=seed)
            pair = _int8_pair(kv)
            for name, layer, s8 in (("paged_attention", kv, False),
                                    ("paged_attention_int8", pair, False),
                                    ("paged_attention_int8[s8]", pair, True)):
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8)
                torch.cuda.synchronize()
                record(name, case, dname, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8))

        # K-B: 8 prompts of 17-2048 tokens, two of them prefix-cached; fp
        # cache and int8 pages.
        q, kv, pages, lo, hi, T = _flat_case(flat_lens, flat_cached, dt, seed=7,
                                             pad_rows=13, pad_pages=3)
        for name, layer in (("flat_prefill_attention", kv),
                            ("flat_prefill_attention_int8", _int8_pair(kv))):
            got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, scale)
            torch.cuda.synchronize()
            record(name, "mixed8_cached2", dname, got,
                   att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, scale))
            if got[T:].abs().max().item() != 0.0:
                fail(f"{name}: padding rows are not zero")

        # K-C: tree steps 0 and K-1 at B = 1 and B = 8 (one warm-up ghost).
        for step in (0, SPEC_K - 1):
            for case, (B, bases, ghosts) in tree_cases.items():
                q, kv, bt, ctx, fan = _tree_case(B, step, bases, ghosts, dt, seed=20 + step)
                pair = _int8_pair(kv)
                for name, layer, s8 in (("tree_attention", kv, False),
                                        ("tree_attention_int8", pair, False),
                                        ("tree_attention_int8[s8]", pair, True)):
                    args = (bt, ctx, fan, step, SPEC_K, BLOCK, scale)
                    got = att.tree_attention(q, layer, *args, s8=s8)
                    torch.cuda.synchronize()
                    record(name, f"{case}_step{step}", dname, got,
                           att.tree_attention_plain(q, layer, *args, s8=s8))

        # The same kernels at Qwen3-30B-A3B's attention geometry (Hq/Hkv
        # 32/4, hd 128): the b8 decode and verify, the tree steps, the mixed
        # prefill; fp cache and int8 pairs.
        s128 = QWEN_HEADS[2] ** -0.5
        # The paged kernels at G 8: decode (8 rows), the Qwen3-MoE verify
        # (Q = K+1, 40 rows) and the glue Q = 2K+1 with per-sequence qeff
        # (72 rows: two row passes), in all three cache modes.
        glue8 = (8, 2 * SPEC_K + 1, [n + 64 + SPEC_K + 1 for n in SERVE_LENS8], M_spec, 0)
        for seed, (case, args) in enumerate((("decode_b8", paged_cases["decode_b8"]),
                                             ("verify_b8", paged_cases["verify_b8"]),
                                             (f"glue_q{2 * SPEC_K + 1}", glue8))):
            q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=40 + seed, heads=QWEN_HEADS)
            if case.startswith("glue"):
                qeff = torch.tensor([SPEC_K + 1 + b % (SPEC_K + 1) for b in range(8)],
                                    dtype=torch.int32, device="cuda")
            pair = _int8_pair(kv)
            for name, layer, s8 in (("paged_attention", kv, False),
                                    ("paged_attention_int8", pair, False),
                                    ("paged_attention_int8[s8]", pair, True)):
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, s128, s8=s8)
                torch.cuda.synchronize()
                record(name, f"{case}_hd128_g8", dname, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, s128, s8=s8))
        q, kv, pages, lo, hi, T = _flat_case(flat_lens, flat_cached, dt, seed=42, pad_rows=13,
                                             pad_pages=3, heads=QWEN_HEADS)
        for name, layer in (("flat_prefill_attention", kv),
                            ("flat_prefill_attention_int8", _int8_pair(kv))):
            got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, s128)
            torch.cuda.synchronize()
            record(name, "mixed8_cached2_hd128", dname, got,
                   att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, s128))
            if got[T:].abs().max().item() != 0.0:
                fail(f"{name} hd 128: padding rows are not zero")
        B, bases, ghosts = tree_cases["tree_b8"]
        q, kv, bt, ctx, fan = _tree_case(B, SPEC_K - 1, bases, ghosts, dt, seed=43,
                                         heads=QWEN_HEADS)
        for name, layer in (("tree_attention", kv), ("tree_attention_int8", _int8_pair(kv))):
            args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, s128)
            got = att.tree_attention(q, layer, *args)
            torch.cuda.synchronize()
            record(name, f"tree_b8_step{SPEC_K - 1}_hd128", dname, got,
                   att.tree_attention_plain(q, layer, *args))

        # K6: the grouped GEMM at the Qwen3-30B-A3B expert shapes, rows from
        # a seeded router: the prefill dispatch of the serve prompts and a
        # b8 decode dispatch, gate/up (D -> Im) and down (Im -> D).
        for case, (offs, K, Nout) in gmm_cases.items():
            x, w = _gmm_case(offs, K, Nout, dt, seed=50)
            got = moe.grouped_gemm(x, w, offs)
            torch.cuda.synchronize()
            record("grouped_gemm", case, dname, got, moe.grouped_gemm_plain(x, w, offs))
            del x, w, got

    _paged_batch_invariance(serve8)
    _flat_batch_invariance()

    # Times at the main-path shapes in bf16 (the serving dtype).
    counts = [w.launches for w in wrappers]
    timings = {}
    dt, dname = torch.bfloat16, "bfloat16"
    elem = 2
    Hq, Hkv, hd = 32, 8, 64
    fp_pos, i8_pos = 2 * hd * elem, 2 * hd + 8   # bytes per (position, KV head)

    def time_paged(Q, ctx_lens, M, seed, shape, mode=None, iters=50, plain_iters=10):
        q, kv, bt, ctx, qeff = _paged_case(len(ctx_lens), Q, ctx_lens, M, 0, dt, seed=seed)
        C = M * BLOCK
        layer = kv if mode is None else _int8_pair(kv)
        s8 = mode == "int8_mxu"
        bytes_, ops = _paged_work(q, ctx, bt, Q, C, Hkv, fp_pos if mode is None else i8_pos, elem)
        peak = PEAK_OPS_INT8 if s8 else PEAK_FLOPS[dname]
        return _timing(
            shape + ("" if mode is None else f", {mode} cache"),
            lambda: att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8),
            lambda: att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8),
            _sdpa_paged(q, layer, bt, ctx, Q, C, dt), bytes_, ops, peak, iters, plain_iters)

    decode_shape = f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv 32/8 hd 64 bf16"
    # The SD/SSD b8 verify halfway through 128 tokens: the same batch with
    # the K+1 verified tokens in the context.
    verify_ctx = [n + SPEC_K + 1 for n in serve8]
    verify_shape = f"verify B=8 (ctx {verify_ctx}) Q={SPEC_K + 1} Hq/Hkv 32/8 hd 64 bf16"
    at_verify = {}
    for name, mode in (("paged_attention", None), ("paged_attention_int8", "int8"),
                       ("paged_attention_int8[s8]", "int8_mxu")):
        timings[name] = time_paged(1, serve8, M, 11, decode_shape, mode)
        at_verify[name] = time_paged(SPEC_K + 1, verify_ctx, M_spec, 12, verify_shape, mode)
        emit("kernels", kernel=name, timing=at_verify[name])
    # The regime the int8 cache exists for: B=8 at LONG_CTX tokens each.
    long_ctx = {}
    M_long = LONG_CTX // BLOCK
    for name, mode in (("paged_attention", None), ("paged_attention_int8", "int8"),
                       ("paged_attention_int8[s8]", "int8_mxu")):
        long_ctx[name] = time_paged(
            1, [LONG_CTX] * 8, M_long, 14,
            f"decode B=8 x {LONG_CTX} tokens Q=1 Hq/Hkv 32/8 hd 64 bf16", mode,
            iters=20, plain_iters=3)
        emit("kernels", kernel=name, long_context=long_ctx[name])

    def flat_timing(lens, cached, seed, shape, int8):
        q, kv, pages, lo, hi, T = _flat_case(lens, cached, dt, seed=seed)
        layer = _int8_pair(kv) if int8 else kv
        n_pages = sum(-(-c // BLOCK) for c in lens)
        bytes_ = (n_pages * BLOCK * Hkv * (i8_pos if int8 else fp_pos)
                  + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4)
        ops = int(4 * Hq * hd * (hi - lo).long().sum())
        dense = att.dense_pages(layer, pages, BLOCK).to(dt)          # [Hkv, C, 2hd]
        kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
        qs = q.permute(1, 0, 2)[None].contiguous()                  # [1, Hq, T, hd]
        col = torch.arange(dense.shape[1], device="cuda")
        mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
        return _timing(
            shape.format(T=T) + (", int8 pages" if int8 else ""),
            lambda: att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, scale),
            lambda: att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, scale),
            lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname],
            iters=10, plain_iters=3)

    prefill_shape = (f"prefill 8 prompts ctx {flat_lens}, cached {flat_cached}, "
                     "T={T} Hq/Hkv 32/8 hd 64 bf16")
    timings["flat_prefill_attention"] = flat_timing(flat_lens, flat_cached, 13,
                                                    prefill_shape, False)
    timings["flat_prefill_attention_int8"] = flat_timing(flat_lens, flat_cached, 13,
                                                         prefill_shape, True)
    # Row #4 of the TPU kernel table (the JAX draft prefill's grouped
    # kernel) is computed here by K1: its time at the draft-prefill shape,
    # the serve b8 prompts with nothing cached.
    draft_prefill = flat_timing(
        SERVE_LENS8, [0] * 8, 17,
        f"draft prefill, 8 prompts {SERVE_LENS8}, nothing cached, T={{T}} Hq/Hkv 32/8 hd 64 bf16",
        False)
    emit("kernels", kernel="flat_prefill_attention", tpu_row="#4 _paged_attn_kernel "
         "(draft prefill)", timing=draft_prefill)

    # The tree build's last step at b8: the serve b8 batch after 64 steps;
    # then at B=1 over 2048 positions of prefix (tree_b1, the b1 SSD path).
    step = SPEC_K - 1
    q, kv, bt, ctx, fan = _tree_case(8, step, [n + 64 for n in SERVE_LENS8], 0, dt, seed=31)
    timings.update(_tree_timings(q, kv, bt, ctx, fan, "B=8", LLAMA_HEADS))
    B, bases, _ = tree_cases["tree_b1"]
    q, kv, bt, ctx, fan = _tree_case(B, step, bases, 0, dt, seed=32)
    tree_b1 = _tree_timings(q, kv, bt, ctx, fan, "B=1", LLAMA_HEADS)
    for name, tm in tree_b1.items():
        emit("kernels", kernel=name, tree_b1=tm)
    del q, kv

    # K1 and K2 at Qwen3-30B-A3B's attention geometry (Hq/Hkv 32/4, hd 128):
    # the moe phase's b8 decode halfway through and its b8 prefill.
    qwen = {}
    Hq, Hkv, hd = QWEN_HEADS
    s128, fp_pos = hd ** -0.5, 2 * hd * elem
    q, kv, bt, ctx, qeff = _paged_case(8, 1, serve8, M, 0, dt, seed=44, heads=QWEN_HEADS)
    bytes_, ops = _paged_work(q, ctx, bt, 1, M * BLOCK, Hkv, fp_pos, elem)
    qwen["paged_attention"] = _timing(
        f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv 32/4 hd 128 bf16",
        lambda: att.paged_attention(q, kv, bt, ctx, qeff, BLOCK, s128),
        lambda: att.paged_attention_plain(q, kv, bt, ctx, qeff, BLOCK, s128),
        _sdpa_paged(q, kv, bt, ctx, 1, M * BLOCK, dt), bytes_, ops, PEAK_FLOPS[dname])
    q, kv, pages, lo, hi, T = _flat_case(SERVE_LENS8, [0] * 8, dt, seed=45, heads=QWEN_HEADS)
    n_pages = sum(-(-n // BLOCK) for n in SERVE_LENS8)
    bytes_ = n_pages * BLOCK * Hkv * fp_pos + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4
    ops = int(4 * Hq * hd * (hi - lo).long().sum())
    dense = att.dense_pages(kv, pages, BLOCK)
    kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
    qs = q.permute(1, 0, 2)[None].contiguous()
    col = torch.arange(dense.shape[1], device="cuda")
    mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
    qwen["flat_prefill_attention"] = _timing(
        f"prefill 8 prompts {SERVE_LENS8}, nothing cached, T={T} Hq/Hkv 32/4 hd 128 bf16",
        lambda: att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s128),
        lambda: att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s128),
        lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname], iters=10, plain_iters=3)
    del q, kv, kd, vd, dense
    for name, tm in qwen.items():
        emit("kernels", kernel=name, qwen3_moe_geometry=tm)

    # K6 at the four dispatch shapes; the prefill gate call is its headline.
    gmm_times = {}
    for case, (offs, K, Nout) in gmm_cases.items():
        x, w = _gmm_case(offs, K, Nout, dt, seed=51)
        want = moe.grouped_gemm_plain(x, w, offs)
        N = x.shape[0]
        active = int((offs[1:] > offs[:-1]).sum())
        bytes_ = (N * K + active * K * Nout + N * Nout) * elem + offs.numel() * 4
        library, label = _grouped_mm_yardstick(x, w, offs, want)
        tm = _timing(f"{case}: N={N} rows over {active} of {offs.numel() - 1} experts, "
                     f"K={K} -> Nout={Nout} bf16",
                     lambda: moe.grouped_gemm(x, w, offs),
                     lambda: moe.grouped_gemm_plain(x, w, offs),
                     library, bytes_, 2 * N * K * Nout, PEAK_FLOPS[dname],
                     iters=20, plain_iters=3)
        tm["library"] = label
        tm["route"] = moe.grouped_gemm_route(x.dtype, N, offs.numel() - 1)
        gmm_times[case] = tm
        emit("kernels", kernel="grouped_gemm", timing=tm)
        del x, w, want
    timings["grouped_gemm"] = gmm_times["prefill_gate"]

    # Llama-3.1-8B's attention (Hq/Hkv 32/8, hd 128, G 4: the eagle phase's
    # target and head): K1 at the EAGLE draft prefill of the 8 serve prompts
    # (each prompt's n-1 tokens at draft positions 0..n-2, nothing cached)
    # and K2 at the glue shape Q = 2K+1 with a per-sequence qeff of
    # n_ext + K + 1, held against their plain versions in both dtypes, then
    # timed in bf16.
    Hq, Hkv, hd = LLAMA8B_HEADS
    s8b, fp_pos = hd ** -0.5, 2 * hd * elem
    draft_lens = [n - 1 for n in _eagle_lens()]
    W = 2 * SPEC_K + 1
    glue_ctx = [n + 64 + SPEC_K + 1 for n in _eagle_lens()]   # base + 1 + K, 64 steps in
    glue_qeff = [SPEC_K + 1 + (b % (SPEC_K + 1)) for b in range(8)]  # n_ext 0..K

    def glue_case(dtc, seed):
        q, kv, bt, ctx, _ = _paged_case(8, W, glue_ctx, M_spec, 0, dtc, seed=seed,
                                        heads=LLAMA8B_HEADS)
        return q, kv, bt, ctx, torch.tensor(glue_qeff, dtype=torch.int32, device="cuda")

    # The other shapes of the eagle phase at G 4, where a Q=1 step takes
    # K2/K4's 4-row instantiation (Q*G = 4) and Q=K+1 the 8-row one: the
    # target's b8 decode 64 steps in, its verify, and the head's last chain
    # step (draft context base + K with base = num_tokens - 2), all over the
    # EAGLE_MAX_LEN table; then K3/K5 at the head's last tree step.
    M_e = EAGLE_MAX_LEN // BLOCK
    at64 = [n + 64 for n in _eagle_lens()]
    eagle_paged = {"decode_b8": (8, 1, at64, M_e, 0),
                   "verify_b8": (8, SPEC_K + 1, [n + SPEC_K + 1 for n in at64], M_e, 0),
                   "chain_b8": (8, 1, [n - 2 + SPEC_K for n in at64], M_e, 0)}
    paged_layers = (("paged_attention", False, False), ("paged_attention_int8", True, False),
                    ("paged_attention_int8[s8]", True, True))

    for dn, dtc in dts.items():
        q, kv, pages, lo, hi, T = _flat_case(draft_lens, [0] * 8, dtc, seed=60,
                                             heads=LLAMA8B_HEADS)
        got = att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s8b)
        torch.cuda.synchronize()
        record("flat_prefill_attention", "eagle_draft_prefill_hd128_g4", dn, got,
               att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s8b))
        cases = [(f"eagle_glue_q{W}", glue_case(dtc, 61))]
        cases += [(f"eagle_{case}", _paged_case(*args, dtc, seed=64 + i, heads=LLAMA8B_HEADS))
                  for i, (case, args) in enumerate(eagle_paged.items())]
        for case, (q, kv, bt, ctx, qeff) in cases:
            pair = _int8_pair(kv)
            for name, int8, s8 in paged_layers:
                layer = pair if int8 else kv
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, s8b, s8=s8)
                torch.cuda.synchronize()
                record(name, f"{case}_hd128_g4", dn, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, s8b, s8=s8))
        q, kv, bt, ctx, fan = _tree_case(8, SPEC_K - 1, [n - 2 for n in at64], 0, dtc,
                                         seed=67, heads=LLAMA8B_HEADS)
        pair = _int8_pair(kv)
        for name, int8, s8 in paged_layers:
            name = name.replace("paged", "tree")
            layer = pair if int8 else kv
            args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, s8b)
            got = att.tree_attention(q, layer, *args, s8=s8)
            torch.cuda.synchronize()
            record(name, f"eagle_tree_b8_step{SPEC_K - 1}_hd128_g4", dn, got,
                   att.tree_attention_plain(q, layer, *args, s8=s8))
        del q, kv, pair, cases
    eagle_t = {}
    q, kv, pages, lo, hi, T = _flat_case(draft_lens, [0] * 8, dt, seed=62, heads=LLAMA8B_HEADS)
    n_pages = sum(-(-n // BLOCK) for n in draft_lens)
    bytes_ = n_pages * BLOCK * Hkv * fp_pos + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4
    ops = int(4 * Hq * hd * (hi - lo).long().sum())
    dense = att.dense_pages(kv, pages, BLOCK)
    kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
    qs = q.permute(1, 0, 2)[None].contiguous()
    col = torch.arange(dense.shape[1], device="cuda")
    mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
    eagle_t["flat_prefill_attention"] = _timing(
        f"EAGLE draft prefill, 8 prompts {draft_lens}, nothing cached, T={T} "
        f"Hq/Hkv 32/8 hd 128 bf16",
        lambda: att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s8b),
        lambda: att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s8b),
        lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname], iters=10, plain_iters=3)
    del kd, vd, dense
    q, kv, bt, ctx, qeff = glue_case(dt, 63)
    C = M_spec * BLOCK
    rows = torch.arange(W, device="cuda")[None, :]
    limit = torch.minimum(ctx[:, None].long() - qeff[:, None].long() + rows + 1,
                          ctx[:, None].long())                        # attended per row
    bytes_ = (int(ctx.long().sum()) * Hkv * fp_pos + 2 * q.numel() * elem
              + bt.numel() * 4 + 2 * ctx.numel() * 4)
    k, v = att.gather_pages(kv, bt, BLOCK, C)
    k = k.permute(0, 2, 1, 3).contiguous()
    v = v.permute(0, 2, 1, 3).contiguous()
    pos = torch.arange(C, device="cuda")[None, None, :]
    gmask = (pos < limit[:, :, None])[:, None]
    qg = q.permute(0, 2, 1, 3).contiguous()
    eagle_t["paged_attention"] = _timing(
        f"EAGLE glue B=8 (ctx {glue_ctx}) Q={W} qeff {glue_qeff} Hq/Hkv 32/8 hd 128 bf16",
        lambda: att.paged_attention(q, kv, bt, ctx, qeff, BLOCK, s8b),
        lambda: att.paged_attention_plain(q, kv, bt, ctx, qeff, BLOCK, s8b),
        lambda: sdpa(qg, k, v, gmask), bytes_, 4 * Hq * hd * int(limit.sum()),
        PEAK_FLOPS[dname])
    del k, v
    # K3/K5 at the head's last tree step, the glue's contexts + K MQ rows.
    q, kv, bt, ctx, fan = _tree_case(8, SPEC_K - 1, [n - 2 for n in at64], 0, dt, seed=68,
                                     heads=LLAMA8B_HEADS)
    eagle_t.update(_tree_timings(q, kv, bt, ctx, fan, "EAGLE B=8", LLAMA8B_HEADS))
    del q, kv
    for name, tm in eagle_t.items():
        emit("kernels", kernel=name, llama31_8b_eagle=tm)

    int8_t = _int8_linear_kernels(record)
    timings["int8_linear"] = int8_t["gate_up_m8"]
    tp_t = _tp_kernels(record)
    open_llama = _head_dim_kernels(record)

    probes_out = _probe_kernels(record, serve8)
    timings.update(probes_out["timings"])

    for name, tm in timings.items():
        emit("kernels", kernel=name, timing=tm)
    for w, n in zip(wrappers, counts):
        w.launches = n
    return {"errors": results, "timings": timings, "at_verify": at_verify,
            "long_context": long_ctx, "qwen3_moe": qwen, "grouped_gemm": gmm_times,
            "llama31_8b_eagle": eagle_t, "tree_b1": tree_b1, "probes": probes_out,
            "int8_linear": int8_t, "llama31_70b_tp4": tp_t, "open_llama_3b": open_llama}


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def _write_config(d: str, base: dict = LLAMA_1B, **over):
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({**base, **over}, f)


def _serving_llm(**kw):
    """The full-width Llama-3.2-1B engine with random bf16 weights."""
    from ssd_tpu_torch import LLM

    with tempfile.TemporaryDirectory() as d:
        _write_config(d)
        return LLM(d, init_random=True, dtype="bfloat16", max_model_len=2048,
                   kvcache_block_size=BLOCK, max_num_seqs=8, **kw)


def _serving_prompts(V: int = LLAMA_1B["vocab_size"]):
    """8 prompts of mixed length (33-1900 tokens) and one of 512, token ids
    below V."""
    import numpy as np

    rng = np.random.default_rng(0)
    return ([rng.integers(3, V, size=n).tolist() for n in SERVE_LENS8],
            [rng.integers(3, V, size=512).tolist()])


@contextlib.contextmanager
def _eager(llm):
    """Inside the block the engine's decode-side steps run eagerly: its
    runners' CUDA graphs are detached, which leaves the path that
    enforce_eager=True runs (the same step functions, launched one by one),
    on the same weights and KV pool, so graph and eager alternate in one
    process."""
    runners = _runners(llm)
    saved = [r.graphs for r in runners]
    for r in runners:
        r.graphs = None
    try:
        yield
    finally:
        for r, g in zip(runners, saved):
            r.graphs = g


def _draft_replicas(llm) -> list:
    """The runners of the unfused async draft server on this card (one per
    draft_dp replica); none for a draft on ranks of its own."""
    return list(getattr(llm.draft_server, "runners", []))


def _runners(llm) -> list:
    """The engine's model runners: the target, and the draft (inline, or
    the unfused async draft server's replicas)."""
    rs = [llm.model_runner, llm.draft_runner] + _draft_replicas(llm)
    return [r for r in rs if r is not None]


def _step_graphs(llm) -> list:
    """The engine's StepGraphs: its own, and each async draft replica's."""
    gs = [llm.graphs] + [r.graphs for r in _draft_replicas(llm)]
    return [g for g in gs if g is not None]


def _graph_facts(llm) -> dict | None:
    """Graphs, capture seconds and reserved bytes of an engine's captures
    (its own StepGraphs, and the unfused async draft's under "draft", a
    second replica's under "draft1")."""
    if llm.graphs is None:
        return None
    facts = llm.graphs.summary()
    for i, g in enumerate(_step_graphs(llm)[1:]):
        facts["draft" + (str(i) if i else "")] = g.summary()
    return facts


def _replays(llm) -> int:
    """Graph replays so far, over every StepGraphs of the engine."""
    return sum(g.replays for g in _step_graphs(llm))


REPEATS = ("graph", "eager", "eager", "graph", "graph", "eager")   # in turns


def _decode_run(llm, prompts, sp, V, label, eager: bool) -> dict:
    """One measured generate: launch counts zeroed just before and read just
    after, graph replays a decode step, decode tok/s."""
    import torch

    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    replays0 = _replays(llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _eager(llm) if eager else contextlib.nullcontext():
        outs, m = llm.generate(prompts, sp, use_tqdm=False)
    wall = time.perf_counter() - t0
    n_new = sp.max_new_tokens
    for o in outs:
        ids = o["token_ids"]
        if len(ids) != n_new or not all(0 <= t < V for t in ids):
            fail(f"{label}: bad output of {len(ids)} tokens")
    steps = max(1, len(m["target_step_times"]) - 1)
    return dict(
        prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
        new_tokens=n_new * len(prompts), wall_s=wall, ttft_s=m["target_step_times"][0],
        prefill_tok_s=m["prefill_total_tokens"] / m["prefill_total_time"],
        decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
        decode_step_ms=1e3 * m["decode_total_time"] / steps,
        graph_replays_per_decode_step=(_replays(llm) - replays0) / steps,
        launches={w.__name__: w.launches for w in wrappers},
        tokens=[o["token_ids"] for o in outs])


def _spread(xs: list[float]) -> dict:
    ys = sorted(xs)
    return dict(min=ys[0], median=ys[len(ys) // 2], max=ys[-1], all=xs)


def _graph_vs_eager(llm, runs_of, V, label, repeats=REPEATS, eager_new=None) -> dict:
    """Graph and eager generates of the same engine in turns, per batch:
    decode tok/s of each repeat with min / median / max, the first graph
    run's launch counts (and the first eager run's beside them) and
    replays a step. The first run prefills its prompts fresh, the later ones
    find them in the prefix cache and recompute only the last token, whose
    K/V and logits then come from GEMMs of other shapes: so the two modes'
    greedy tokens are held equal over the later runs (`tokens_equal`), and
    the first run's against them is reported (`fresh_run_equal`). With
    eager_new, an eager turn serves that many tokens, and the tokens are
    compared over them."""
    from ssd_tpu_torch import SamplingParams

    out = {}
    for name, (prompts, sp) in runs_of.items():
        runs = {"graph": [], "eager": []}
        esp = sp if eager_new is None else SamplingParams(
            temperature=0.0, max_new_tokens=eager_new, ignore_eos=True)
        for mode in repeats:
            runs[mode].append(_decode_run(llm, prompts, esp if mode == "eager" else sp, V,
                                          f"{label} {name} {mode}", eager=mode == "eager"))
        n = eager_new or sp.max_new_tokens
        for r in runs["graph"] + runs["eager"]:
            r["tokens"] = [t[:n] for t in r["tokens"]]
        g0, e0 = runs["graph"][0], runs["eager"][0]
        out[name] = dict(
            decode_tok_s={k: _spread([r["decode_tok_s"] for r in v]) for k, v in runs.items()},
            decode_step_ms={k: _spread([r["decode_step_ms"] for r in v]) for k, v in runs.items()},
            ttft_s={k: _spread([r["ttft_s"] for r in v]) for k, v in runs.items()},
            graph_replays_per_decode_step=g0["graph_replays_per_decode_step"],
            launches=g0["launches"], launches_eager=e0["launches"],
            tokens_equal=all(r["tokens"] == e0["tokens"] for v in runs.values()
                             for r in v if r is not g0),
            fresh_run_equal=g0["tokens"] == e0["tokens"], ttft_fresh_s=g0["ttft_s"],
            prompts=g0["prompts"], prompt_tokens=g0["prompt_tokens"],
            new_tokens=g0["new_tokens"])
        emit(label, run=name, **out[name])
    return out


def phase_serve() -> dict:
    """AR (and AR multi-step) at the full Llama-3.2-1B width (module
    docstring, phase 3)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    V = LLAMA_1B["vocab_size"]
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    warm = SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True)
    prompts8, prompt1 = _serving_prompts()
    out = {"launches": {}}
    for label, kw in (("serve", {}), ("serve_multi_step", dict(multi_step=SERVE_M))):
        t0 = time.perf_counter()
        llm = _serving_llm(**kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        for eager in (False, True):   # warm-up: cuBLAS handles, allocator
            with _eager(llm) if eager else contextlib.nullcontext():
                llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
        runs = _graph_vs_eager(llm, {"b8": (prompts8, sp), "b1": (prompt1, sp)}, V, label,
                               ("graph", "eager", "graph"))
        launches = {k: sum(r["launches"][k] for r in runs.values())
                    for k in ("paged_attention", "flat_prefill_attention")}
        emit(label, geometry="Llama-3.2-1B (16 layers, random bf16 weights)", **kw,
             init_s=init_s, graphs=_graph_facts(llm),
             kv_blocks=llm.model_runner.num_kvcache_blocks, pool=llm.model_runner.pool_sizing,
             launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        if not all(n > 0 for n in launches.values()):
            fail(f"{label}: a kernel of the main path never launched: {launches}")
        for name, r in runs.items():
            if not r["tokens_equal"]:
                fail(f"{label} {name}: graph and eager greedy tokens differ")
            if r["launches"] != r["launches_eager"]:
                fail(f"{label} {name}: launches through replays {r['launches']} differ from "
                     f"the eager run's {r['launches_eager']}")
            if not r["graph_replays_per_decode_step"] > 0:
                fail(f"{label} {name}: no graph replayed")
        out["launches"]["ar" if label == "serve" else "ar_multi"] = launches
        out[label] = dict(runs=runs, init_s=init_s, graphs=_graph_facts(llm),
                          pool=llm.model_runner.pool_sizing)
        del llm
        torch.cuda.empty_cache()
    out["pool"] = out["serve"]["pool"]
    return out


def phase_profile(moe: bool = False, quantization: str | None = None) -> dict:
    """Not run by default: where a serving step's time goes. The same engine
    and prompts as `serve` (with moe=True, as `moe`; with quantization,
    its int8-weight form, as `quant`); one prefill step of the 8 prompts,
    then a window of decode steps at b=8, each timed without and then with
    torch.profiler, which gives the device's busy time (sum of kernel
    times; one stream) and the kernels that take it, K9's summed over its
    kernels under int8 weights."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssd_tpu_torch import SamplingParams

    if moe:
        llm, _ = _moe_llm(quantization)
        prompts8, _ = _serving_prompts(QWEN3_30B_A3B["vocab_size"])
    else:
        llm = _serving_llm(quantization=quantization)
        prompts8, _ = _serving_prompts()
    llm.generate([p[:40] for p in prompts8[:2]],
                 SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True),
                 use_tqdm=False)  # warm-up

    def window(steps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            llm.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sp = SamplingParams(temperature=0.0, max_new_tokens=100, ignore_eos=True)
    out = {"graphs": _graph_facts(llm)}
    for label, steps in (("prefill_b8", 1), ("decode_b8", 20), ("decode_b8_eager", 20)):
        replays0 = llm.graphs.replays if llm.graphs is not None else 0
        with _eager(llm) if label.endswith("eager") else contextlib.nullcontext():
            if label == "prefill_b8":
                for p in prompts8:
                    llm.add_request(p, sp)
                plain_s = None   # the prefill happens once
            else:
                plain_s = window(steps)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_s = window(steps)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        n_windows = 1 if plain_s is None else 2
        out[label] = dict(
            steps=steps, kernels_per_step=sum(e.count for e in kernels) / steps,
            graph_replays_per_step=(0 if llm.graphs is None else
                                    (llm.graphs.replays - replays0) / (n_windows * steps)),
            wall_ms_per_step=None if plain_s is None else plain_s * 1e3 / steps,
            profiled_wall_ms_per_step=prof_s * 1e3 / steps,
            device_busy_ms_per_step=busy_us / 1e3 / steps,
            device_busy_share=busy_us / 1e6 / (plain_s or prof_s),
            top_kernels=[dict(name=e.key[:90], ms_per_step=e.self_device_time_total / 1e3 / steps,
                              calls=e.count) for e in top])
        k9 = [e for e in kernels if "w8a16" in e.key or "w8_f32" in e.key]
        if k9:   # K9 (int8 weights): all its kernels, every route
            out[label].update(
                k9_ms_per_step=sum(e.self_device_time_total for e in k9) / 1e3 / steps,
                k9_calls_per_step=sum(e.count for e in k9) / steps)
    emit(("moe_profile" if moe else "profile") + ("_int8" if quantization else ""),
         geometry=MOE_GEOMETRY if moe else "Llama-3.2-1B (16 layers, random bf16 weights)",
         quantization=quantization, **out)
    llm.exit()
    del llm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------

PROJ = ("wq", "wk", "wv", "wo", "gate", "up", "down")
HF_PROJ = tuple(f"{m}_proj" for m in ("self_attn.q", "self_attn.k", "self_attn.v",
                                      "self_attn.o", "mlp.gate", "mlp.up", "mlp.down"))


def _spec_pair(d: str, layers: int, live: int, scale: float, dtype, seed: int,
               base: dict = LLAMA_1B, draft_noise: float = 0.0):
    """Write a target/draft checkpoint pair with the construction of the JAX
    package's bench.py::build_spec_checkpoints: the target's layers >= live
    have o_proj = down = 0 (an exact residual pass-through) and the draft is
    the target's `live` layers with the same embeddings (and LM head), so
    greedy tokens agree while the draft costs live/layers of the target.
    Random normal weights times `scale` from a generator seeded with `seed`,
    drawn on the card, at the geometry of the config `base`; with
    draft_noise, the draft is written as _perturb_draft(llm, draft_noise,
    scale) leaves it once loaded (the same unit normals, _layer_noise, added
    in the checkpoint's dtype), so the target stays the same. Returns
    (target dir, draft dir)."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = base
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    D, I = c["hidden_size"], c["intermediate_size"]
    hd = c.get("head_dim") or D // Hq
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, zero=False):
        x = torch.randn(*shape, generator=g, device="cuda") * scale
        return (torch.zeros_like(x) if zero else x).to(dtype).cpu()

    def ones(n):
        return torch.ones(n, dtype=dtype)

    target = {"model.embed_tokens.weight": w(c["vocab_size"], D),
              "model.norm.weight": ones(D)}
    if not c["tie_word_embeddings"]:
        target["lm_head.weight"] = w(c["vocab_size"], D)
    draft = dict(target)
    for i in range(layers):
        p = f"model.layers.{i}."
        dead = i >= live
        layer = {
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd, zero=dead),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I, zero=dead),
        }
        target.update(layer)
        if not dead:
            draft.update(layer)
    if draft_noise:
        for i in range(live):
            # The loaded projections are the checkpoint's transposed, in PROJ's order.
            names = [f"model.layers.{i}.{m}.weight" for m in HF_PROJ]
            units = _layer_noise(i, tuple(tuple(draft[n].shape[::-1]) for n in names))
            for n, u in zip(names, units):
                draft[n] = draft[n] + (u * (scale * draft_noise)).to(dtype).T
    dirs = []
    for name, tensors, n in (("target", target, layers), ("draft", draft, live)):
        sub = os.path.join(d, name)
        os.makedirs(sub)
        save_safetensors(os.path.join(sub, "model.safetensors"), tensors)
        _write_config(sub, base, num_hidden_layers=n)
        dirs.append(sub)
    return tuple(dirs)


def _kernel_wrappers() -> tuple:
    """Every kernel wrapper whose `launches` a run zeroes and reads."""
    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import linear, moe

    return att.KERNEL_WRAPPERS + (moe.grouped_gemm, linear.int8_linear)


def _draft_params(llm, replica: int = 0) -> dict:
    runner = (_draft_replicas(llm)[replica] if llm.draft_server is not None
              else llm.draft_runner)
    return runner.params


def _perturb_draft(llm, noise: float, scale: float):
    """bench.py's draft_noise on the freshly loaded draft: every projection
    of the live layers becomes w + (scale * noise) * N(0, 1), drawn from a
    host generator seeded 1000 + layer. An int8 projection's per-channel
    scales become s * (1 + noise * N(0, 1)) instead (the int8 values stay).
    Every draft_dp replica takes the same noise."""
    import torch

    for r in range(max(1, len(_draft_replicas(llm)))):
        _perturb_layers(_draft_params(llm, r), noise, scale)
    torch.cuda.synchronize()


_UNIT_NOISE: dict = {}   # (layer, the shapes it draws) -> its unit normals


def _layer_noise(i: int, shapes: tuple) -> list:
    """Layer i's unit normals, one tensor per shape in order, from a host
    generator seeded 1000 + i. Drawn once and kept: the runs perturb drafts
    of the same shapes again and again, and the draws cost seconds."""
    import torch

    key = (i, shapes)
    if key not in _UNIT_NOISE:
        g = torch.Generator().manual_seed(1000 + i)
        _UNIT_NOISE[key] = [torch.randn(s, generator=g) for s in shapes]
    return _UNIT_NOISE[key]


def _perturb_layers(params: dict, noise: float, scale: float):
    for i, lp in enumerate(params["layers"]):
        # Drawn on the host, so the card's and the CPU's drafts are the same.
        leaves = [lp[k + "_scale"] if k + "_scale" in lp else lp[k] for k in PROJ]
        units = _layer_noise(i, tuple(tuple(x.shape) for x in leaves))
        for k, x, u in zip(PROJ, leaves, units):
            if k + "_scale" in lp:
                x.copy_(x * (1 + (u * noise).to(x.device)))
            else:
                x.copy_(x + (u * (scale * noise)).to(x.device, x.dtype))


class _Spans:
    """CUDA events around every call of cls.name, recorded on the stream
    that is current in the calling thread (the draft's own stream for the
    tree build, the target's for the verify)."""

    def __init__(self, cls, name):
        import torch

        self.cls, self.name, self.orig = cls, name, getattr(cls, name)
        self.pairs = []
        orig, pairs = self.orig, self.pairs

        def wrapped(obj, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(obj, *args, **kwargs)
            end.record()
            pairs.append((start, end))
            return out

        setattr(cls, name, wrapped)

    def restore(self):
        setattr(self.cls, self.name, self.orig)

    def intervals(self, ref) -> list[tuple[float, float]]:
        return [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in self.pairs]


class _RowsServed:
    """The request rows each of an engine's async draft replicas answered
    (DraftRunner.service calls) while it is installed."""

    def __init__(self, llm):
        from ssd_tpu_torch.engine.draft_runner import DraftRunner

        replicas = {id(r): i for i, r in enumerate(_draft_replicas(llm))}
        self.rows = [0] * len(replicas)
        self.orig = DraftRunner.service
        orig, rows = self.orig, self.rows

        def counted(runner, req):
            rows[replicas[id(runner)]] += req.cache_keys.shape[0]
            return orig(runner, req)

        DraftRunner.service = counted

    def restore(self):
        from ssd_tpu_torch.engine.draft_runner import DraftRunner

        DraftRunner.service = self.orig


def _overlap(builds, verifies) -> dict:
    """How much of the draft's tree-build time on the card fell inside the
    target's verify windows."""
    total = sum(e - s for s, e in builds)
    inside = sum(max(0.0, min(e, ve) - max(s, vs))
                 for s, e in builds for vs, ve in verifies)
    return dict(tree_builds=len(builds), tree_build_ms_total=total,
                verifies=len(verifies), verify_ms_total=sum(e - s for s, e in verifies),
                overlapped_ms=inside, overlap_share_of_build=inside / total if total else None)


def _forget_prefixes(llm):
    """Empty the engine's prefix caches (target and draft), so that the
    next requests prefill as on a fresh engine; the engine must be idle."""
    sch = llm.scheduler
    for bm in [sch.block_manager] + list(getattr(sch, "draft_block_managers", [])):
        bm.hash_to_block_id.clear()


def _spec_llm(tdir, ddir, mode, **kw):
    """The engine of a speculative mode: "sd", "ssd" (unfused async SSD),
    "ssd_dp2" (its draft as two draft_dp replicas on the card), "fasync1"
    (the fused exchange), "fasync<R>" (the fused async superstep, R rounds
    a step), "fused<R>" (sync SD with R rounds a step) or "ngram" (no
    draft; K tokens from the last NGRAM_N, SPEC_R rounds a step)."""
    from ssd_tpu_torch import LLM

    if mode == "ngram":
        return LLM(tdir, ngram_speculate=True, ngram_n=NGRAM_N, speculate_k=SPEC_K,
                   spec_rounds=SPEC_R, **kw)
    async_ = dict(draft_async=True, async_fan_out=SPEC_F)
    extra = (async_ if mode == "ssd" else dict(async_, draft_dp=2) if mode == "ssd_dp2" else
             dict(async_, async_fused=True, spec_rounds=int(mode[6:]))
             if mode.startswith("fasync") else
             dict(spec_rounds=int(mode[5:])) if mode.startswith("fused") else {})
    return LLM(tdir, draft=ddir, speculate=True, speculate_k=SPEC_K, **extra, **kw)


def _spec_run(llm, mode, prompts, n_new, V: int = LLAMA_1B["vocab_size"], eager=False):
    """One measured generate of a main path ("ar", "sd", "ssd" (a plain or
    an EAGLE draft), "ssd_dp2", "fasync<R>", "fused<R>" or "ngram"), with eager the
    engine's graphs detached: launch counts zeroed just before and read just
    after; for the speculative modes the accepted lengths and, async, the
    cache-hit rate; for SD and SSD tree-build/verify spans on the card, the
    draft's step and chain times (SSD: the rows each draft_dp replica
    served); for the fused modes the superstep's time
    (the exchange's verify + tree time); graph replays a decode step."""
    import torch

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.engine.draft_runner import DraftRunner
    from ssd_tpu_torch.engine.speculator_sync import SpeculatorSync
    from ssd_tpu_torch.engine.verifier import Verifier

    sp = SamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True)
    n_steps0 = 0
    unfused = mode in ("ssd", "ssd_dp2")
    if unfused:
        # A tree build left running by an earlier generate (the warm-up)
        # must not launch into this run's counts or spans.
        llm.draft_server.drain()
        n_steps0 = len(llm.draft_server._step_times)
    verify_spans = _Spans(Verifier, "verify")
    build_spans = _Spans(type(llm.draft_server.runner) if unfused else DraftRunner,
                         "build_tree")
    chain_spans = _Spans(SpeculatorSync, "speculate")
    served = _RowsServed(llm) if unfused else None
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    replays0 = _replays(llm)
    t0 = time.perf_counter()
    try:
        with _eager(llm) if eager else contextlib.nullcontext():
            outs, m = llm.generate(prompts, sp, use_tqdm=False)
            if unfused:
                # The tree build answering the last step runs on after
                # generate returns; it belongs to this run, so its
                # launches count.
                llm.draft_server.drain()
    finally:
        launches = {w.__name__: w.launches for w in wrappers}
        for spans in (verify_spans, build_spans, chain_spans, served):
            if spans is not None:
                spans.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for o in outs:
        ids = o["token_ids"]
        if len(ids) != n_new or not all(0 <= t < V for t in ids):
            fail(f"spec {mode}: bad output of {len(ids)} tokens")
    steps = max(1, len(m["target_step_times"]) - 1)
    run = dict(
        prompts=len(prompts), new_tokens=n_new * len(prompts), wall_s=wall,
        ttft_s=m["target_step_times"][0],
        decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
        decode_steps=steps, graph_replays_per_decode_step=(_replays(llm) - replays0) / steps,
        launches=launches)
    if mode == "ar":
        return run, [o["token_ids"] for o in outs]
    lens = m["accepted_suffix_lens_with_recovery"]
    run.update(mean_accepted_suffix_len=sum(lens) / len(lens))
    if m["cache_hits"]:
        run.update(cache_hit_rate=sum(m["cache_hits"]) / len(m["cache_hits"]))
    if m["sd_superstep_times"]:   # fused SD, ngram, the async superstep
        t = m["sd_superstep_times"]
        run.update(spec_steps=len(t), superstep_ms=1e3 * sum(t) / len(t))
        return run, [o["token_ids"] for o in outs]
    run.update(spec_steps=len(m["target_verify_times"]),
               target_verify_ms=1e3 * sum(m["target_verify_times"]) / len(m["target_verify_times"]))
    if unfused:
        steps = llm.draft_server._step_times[n_steps0:]
        run.update(draft_step_ms=1e3 * sum(steps) / len(steps),
                   overlap=_overlap(build_spans.intervals(ref), verify_spans.intervals(ref)),
                   rows_per_replica=served.rows)
    elif mode == "sd":
        chain = chain_spans.intervals(ref)
        run.update(draft_chain_ms=sum(e - s for s, e in chain) / len(chain))
    return run, [o["token_ids"] for o in outs]


# The spec phase's engines: (mode, ((draft noise, batches also run eagerly),
# ...)). One engine serves its levels in turn: the draft is perturbed in
# place (the graphs read the same tensors) and the prefix caches emptied
# between them, so each level starts as a fresh engine would.
SPEC_PLAN = (
    ("sd", ((0.0, ("b8", "b1")), (MISS_NOISE, ("b8",)))),
    ("ssd", ((0.0, ("b8", "b1")), (MISS_NOISE, ()))),
    ("ssd_dp2", ((0.0, ("b8", "b1")), (MISS_NOISE, ()))),
    ("fasync1", ((0.0, ("b8",)), (MISS_NOISE, ()))),
    ("fasync4", ((0.0, ("b8",)), (MISS_NOISE, ()))),
    ("fasync8", ((0.0, ()), (MISS_NOISE, ()))),
    ("fused4", ((0.0, ("b8",)),)), ("fused8", ((0.0, ()),)), ("ngram", ((0.0, ("b8",)),)))
ASYNC_MODES = ("ssd", "ssd_dp2", "fasync1", "fasync4", "fasync8")
# Turns (eager or not) of a batch run eagerly beside graphs; draft_dp's
# comparison (ssd against ssd_dp2 at noise 0) takes three graph turns at b8
# (and one eager turn, cut from two to hold the run's time).
TURNS = (False, True, False)
DP_TURNS = (False, True, False, False)


def phase_spec() -> dict:
    """Sync SD and async SSD at the full Llama-3.2-1B width (module
    docstring, phase 4)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    prompts8, prompt1 = _serving_prompts()
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    out = {"runs": {}, "tokens": {}, "graphs": {}, "noise": MISS_NOISE, "turns": {}}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        out["checkpoints_s"] = time.perf_counter() - t0
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                      kvcache_block_size=BLOCK, max_num_seqs=8)

        for mode, levels in SPEC_PLAN:
            t0 = time.perf_counter()
            llm = _spec_llm(tdir, ddir, mode, **engine)
            out["graphs"][mode] = dict(_graph_facts(llm), init_s=time.perf_counter() - t0,
                                       pool=llm.model_runner.pool_sizing)
            for eager in (False, True):
                with _eager(llm) if eager else contextlib.nullcontext():
                    llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
            for level, eager_batches in levels:
                if level:
                    _perturb_draft(llm, level, 0.02)
                    _forget_prefixes(llm)
                for name, prompts in (("b8", prompts8), ("b1", prompt1)):
                    base = f"{mode}_{name}_noise{level:g}"
                    turns = (DP_TURNS if mode.startswith("ssd") and not level and name == "b8"
                             else TURNS) if name in eager_batches else (False,)
                    for i, eager in enumerate(turns):
                        run, toks = _spec_run(llm, mode, prompts, 128, eager=eager)
                        key = base + ("_eager" if eager else "")
                        out["turns"].setdefault(base, {"graph": [], "eager": []})[
                            "eager" if eager else "graph"].append(run)
                        if key in out["runs"]:   # a later run in turns
                            out["runs"][key]["decode_tok_s_again"] = run["decode_tok_s"]
                        else:
                            out["runs"][key] = run
                            emit("spec", run=key, draft_noise=level, **run)
                        # Runs after the first find the prompts in the prefix
                        # cache (see _graph_vs_eager): graph and eager agree
                        # there, in tokens and, async, in hits and accepted
                        # lengths (the same kernels in the same order).
                        stats = (toks, run.get("cache_hit_rate"),
                                 run["mean_accepted_suffix_len"])
                        if i and stats != out["tokens"].setdefault(base, stats):
                            fail(f"spec {key}: graph and eager greedy tokens, hits or "
                                 f"accepted lengths differ")
                        need = ["paged_attention", "flat_prefill_attention"]
                        need += ["tree_attention"] if mode in ASYNC_MODES else []
                        if not all(run["launches"][k] > 0 for k in need):
                            fail(f"spec {key}: a kernel of the path never launched: "
                                 f"{run['launches']}")
                        if not eager and not run["graph_replays_per_decode_step"] > 0:
                            fail(f"spec {key}: no graph replayed")
                        lo, hi = MISS_HIT_RATE
                        if mode in ASYNC_MODES and level and \
                                not lo <= run["cache_hit_rate"] <= hi:
                            fail(f"spec {key}: the miss path's cache-hit rate "
                                 f"{run['cache_hit_rate']} is outside [{lo}, {hi}]")
                        if mode == "ssd_dp2" and name == "b8" and \
                                not all(run["rows_per_replica"]):
                            fail(f"spec {key}: a draft replica served no rows: "
                                 f"{run['rows_per_replica']}")
            blocks = llm.model_runner.num_kvcache_blocks
            out["pool"] = llm.model_runner.pool_sizing
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    out.pop("tokens")
    out["draft_dp"] = _draft_dp_summary(out.pop("turns"))
    emit("spec", part="draft_dp", **out["draft_dp"])
    emit("spec", geometry="Llama-3.2-1B width, target 16 layers (4 live), draft 4 layers, bf16",
         K=SPEC_K, async_fan_out=SPEC_F, ngram_n=NGRAM_N, ngram_rounds=SPEC_R,
         graphs=out["graphs"], kv_blocks_each_pool=blocks, pool=out["pool"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def _draft_dp_summary(turns: dict) -> dict:
    """draft_dp=2 beside draft_dp=1 (unfused SSD, noise 0) at b8 and b1:
    decode tok/s min / median / max of the graph and the eager turns (b8
    three graph turns, b1 two), hit rates, accepted lengths and the rows
    each replica served, per turn."""
    out = {}
    for mode in ("ssd", "ssd_dp2"):
        for name in ("b8", "b1"):
            runs = turns[f"{mode}_{name}_noise0"]
            out[f"{mode}_{name}"] = dict(
                decode_tok_s={k: _spread([r["decode_tok_s"] for r in v])
                              for k, v in runs.items()},
                cache_hit_rate=[r["cache_hit_rate"] for r in runs["graph"]],
                mean_accepted_suffix_len=[r["mean_accepted_suffix_len"]
                                          for r in runs["graph"]],
                rows_per_replica=[r["rows_per_replica"] for r in runs["graph"]])
    for name in ("b8", "b1"):
        one, two = (out[f"{m}_{name}"]["decode_tok_s"]["graph"]["median"]
                    for m in ("ssd", "ssd_dp2"))
        out[f"dp2_over_dp1_graph_median_{name}"] = two / one
    return out


def phase_spec_async() -> dict:
    """Not run by default: the three async forms (unfused SSD, the fused
    exchange, the fused superstep at R = 4 and 8) on spec's pair at b8 and
    b1, noise 0 and MISS_NOISE, with graphs and with them detached in turns
    (REPEATS: three runs each): decode tok/s min / median / max, hit rate
    and accepted length, graph replays and kernel launches a decode step,
    capture seconds and pool bytes."""
    import torch

    from ssd_tpu_torch import SamplingParams

    prompts8, prompt1 = _serving_prompts()
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                      kvcache_block_size=BLOCK, max_num_seqs=8)
        for level in (0.0, MISS_NOISE):
            for mode in ASYNC_MODES:
                t0 = time.perf_counter()
                llm = _spec_llm(tdir, ddir, mode, **engine)
                init_s = time.perf_counter() - t0
                if level:
                    _perturb_draft(llm, level, 0.02)
                for eager in (False, True):
                    with _eager(llm) if eager else contextlib.nullcontext():
                        llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
                for name, prompts in (("b8", prompts8), ("b1", prompt1)):
                    runs = {"graph": [], "eager": []}
                    for kind in REPEATS:
                        runs[kind].append(_spec_run(llm, mode, prompts, 128,
                                                    eager=kind == "eager")[0])
                    g = runs["graph"][0]
                    key = f"{mode}_{name}_noise{level:g}"
                    out[key] = dict(
                        decode_tok_s={k: _spread([r["decode_tok_s"] for r in v])
                                      for k, v in runs.items()},
                        cache_hit_rate={k: [r["cache_hit_rate"] for r in v]
                                        for k, v in runs.items()},
                        mean_accepted_suffix_len={k: [r["mean_accepted_suffix_len"] for r in v]
                                                  for k, v in runs.items()},
                        graph_replays_per_decode_step=g["graph_replays_per_decode_step"],
                        launches_per_decode_step={k: n / g["decode_steps"]
                                                  for k, n in g["launches"].items() if n},
                        decode_steps=g["decode_steps"])
                    emit("spec_async", run=key, draft_noise=level, **out[key])
                    if not g["launches"]["tree_attention"] > 0 or \
                            not g["graph_replays_per_decode_step"] > 0:
                        fail(f"spec_async {key}: no replay or no tree kernel: {g}")
                out[f"{mode}_noise{level:g}_graphs"] = dict(graphs=_graph_facts(llm),
                                                           init_s=init_s)
                emit("spec_async", engine=f"{mode}_noise{level:g}", init_s=init_s,
                     graphs=_graph_facts(llm))
                llm.exit()
                del llm
                torch.cuda.empty_cache()
    emit("spec_async", geometry="Llama-3.2-1B width, target 16 layers (4 live), draft "
         "4 layers, bf16", K=SPEC_K, async_fan_out=SPEC_F, repeats=REPEATS)
    return out


def phase_kvq(serve: dict | None, spec: dict | None) -> dict:
    """The int8 KV cache at the full Llama-3.2-1B width (module docstring,
    phase 5): AR b8 on serve's engine and prompts, SD and SSD b8 (noise 0)
    on spec's checkpoint pair, with kv_quant="int8", then AR b8 and SSD b8
    with "int8_mxu". Every kernel launch count is zeroed before and read
    after each run; the int8 kernels of the run's path must launch and the
    fp-cache kernels must not."""
    import torch

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.config import ModelConfig
    from ssd_tpu_torch.engine.model_runner import kv_block_bytes
    from ssd_tpu_torch.models.transformer import Arch

    prompts8, _ = _serving_prompts()
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    out = {"runs": {}, "pools": {}}
    need = {"ar": ("paged_attention_int8", "flat_prefill_attention_int8"),
            "sd": ("paged_attention_int8", "flat_prefill_attention_int8"),
            "ssd": ("paged_attention_int8", "flat_prefill_attention_int8",
                    "tree_attention_int8")}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                      kvcache_block_size=BLOCK, max_num_seqs=8)
        for kvq, mode in (("int8", "ar"), ("int8", "sd"), ("int8", "ssd"),
                          ("int8_mxu", "ar"), ("int8_mxu", "ssd")):
            if mode == "ar":
                llm = _serving_llm(kv_quant=kvq)
            else:
                llm = _spec_llm(tdir, ddir, mode, kv_quant=kvq, **engine)
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
            run, _ = _spec_run(llm, mode, prompts8, 128)
            key = f"{kvq}_{mode}_b8"
            run["pool"] = llm.model_runner.pool_sizing
            out["runs"][key] = run
            emit("kvq", run=key, kv_quant=kvq, **run)
            if not run["graph_replays_per_decode_step"] > 0:
                fail(f"kvq {key}: no graph replayed")
            missing = [k for k in need[mode] if run["launches"][k] <= 0]
            fp = [k for k in ("paged_attention", "flat_prefill_attention", "tree_attention")
                  if run["launches"][k]]
            if missing or fp:
                fail(f"kvq {key}: int8 kernels that never launched {missing}, "
                     f"fp-cache kernels that did {fp}: {run['launches']}")
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    # Pool capacity, bf16 next to int8: one block's bytes (target + draft
    # for the speculative engines), and how many blocks the free memory
    # would hold before the engine's cap of (max_num_seqs+1)(max_blocks+2)*4.
    arch = Arch.from_model_config(ModelConfig(**LLAMA_1B))
    for dt_name, kvq in (("bfloat16", None), ("int8", "int8")):
        out["pools"][dt_name] = dict(
            block_bytes_per_layer_stack=kv_block_bytes(arch, BLOCK, torch.bfloat16, kvq),
            blocks_per_gib=2**30 / kv_block_bytes(arch, BLOCK, torch.bfloat16, kvq))
    measured = {"ar_bf16": (serve or {}).get("pool"), "spec_bf16": (spec or {}).get("pool"),
                "ar_int8": out["runs"]["int8_ar_b8"]["pool"],
                "spec_int8": out["runs"]["int8_sd_b8"]["pool"]}
    out["pools"]["measured"] = measured
    emit("kvq", geometry="Llama-3.2-1B width: AR 16 layers (serve's engine); SD/SSD target "
         "16 layers (4 live), draft 4 layers; bf16 weights", pools=out["pools"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def _profile_window(llm, steps: int = 8) -> dict:
    """`steps` decode steps of a warm engine, timed without and then with
    torch.profiler: wall ms per step, the device time of each CUDA stream,
    their union and the time two streams ran kernels at once, the
    host-device copies, the target's verify time on the host, and the
    kernels a step with the top ten by device time (these in the profiled
    window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssd_tpu_torch.bench.diag_timing import stream_busy
    from ssd_tpu_torch.engine.llm_engine import METRICS

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            llm.step()
        if llm.draft_server is not None:
            llm.draft_server.drain()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall = window()
    n_verify = len(METRICS["target_verify_times"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall = window()
    verify = METRICS["target_verify_times"][n_verify:]
    busy = stream_busy(prof)
    copies = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy")]
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return dict(steps=steps, wall_ms_per_step=wall, profiled_wall_ms_per_step=prof_wall,
                device_union_ms_per_step=busy["union_ms"] / steps,
                device_busy_share=busy["union_ms"] / steps / wall,
                per_stream_ms_per_step={k: v / steps for k, v in busy["per_stream_ms"].items()},
                concurrent_ms_per_step=busy["concurrent_ms"] / steps,
                memcpy_per_step=len(copies) / steps,
                memcpy_ms_per_step=sum(e.time_range.end - e.time_range.start
                                       for e in copies) / 1e3 / steps,
                verify_host_ms=1e3 * sum(verify) / len(verify) if verify else None,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                top_kernels=[dict(name=e.key[:90],
                                  ms_per_step=e.self_device_time_total / 1e3 / steps,
                                  calls=e.count) for e in top])


def phase_spec_profile() -> dict:
    """Not run by default: decode steps at b=8 (noise 0) of SD, unfused SSD
    and the fused exchange and superstep (R = 4), under their graphs, timed
    without and then with torch.profiler (a superstep's step is R rounds)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    prompts8, _ = _serving_prompts()
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        for mode in ("sd", "ssd", "fasync1", "fasync4"):
            llm = _spec_llm(tdir, ddir, mode, dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                            kvcache_block_size=BLOCK, max_num_seqs=8)
            for p in prompts8:
                llm.add_request(p, sp)
            # A superstep's step is R rounds: its windows take 8 / R steps,
            # so every window runs before the 128 tokens are out.
            R = int(mode[6:]) if mode.startswith("fasync") else 1
            for _ in range(4 if R == 1 else 2):   # the prefill, then warm decode steps
                llm.step()
            out[mode] = dict(_profile_window(llm, steps=8 // R), rounds_per_step=R,
                             graphs=_graph_facts(llm))
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    emit("spec_profile", geometry="Llama-3.2-1B width, target 16 layers (4 live), "
         "draft 4 layers, bf16, b8, noise 0, CUDA graphs", **out)
    return out


def phase_eagle_profile() -> dict:
    """Not run by default: decode steps at b=8 of EAGLE-3 async SSD and of
    the fused sync superstep (R = SPEC_R) on the eagle phase's Llama-3.1-8B
    engine (full depth, random bf16 weights), under their graphs, timed
    without and then with torch.profiler, per CUDA stream (a superstep's
    step is R rounds)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    p8, _ = _serving_prompts(LLAMA_8B["vocab_size"])
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tdir, edir = os.path.join(d, "t"), os.path.join(d, "e")
        os.makedirs(tdir)
        os.makedirs(edir)
        _write_config(tdir, LLAMA_8B)
        _eagle_config(edir)
        for form in ("ssd", "fused"):
            llm = _eagle_llm(tdir, edir, init_random=True, form=form, dtype="bfloat16",
                             max_model_len=EAGLE_MAX_LEN, kvcache_block_size=BLOCK,
                             max_num_seqs=8)
            for p in _eagle_prompts(p8, 128):
                llm.add_request(p, sp)
            R = SPEC_R if form == "fused" else 1
            for _ in range(4 if R == 1 else 2):   # the prefill, then warm decode steps
                llm.step()
            out[form] = dict(_profile_window(llm, steps=8 // R), rounds_per_step=R,
                             graphs=_graph_facts(llm))
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    emit("eagle_profile", geometry=EAGLE_GEOMETRY + ", b8, CUDA graphs", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 6
# ---------------------------------------------------------------------------


def _moe_llm(quantization: str | None = None):
    """The full-depth Qwen3-30B-A3B engine with random bf16 weights (with
    quantization="int8" quantized at load), built after checking that the
    card's free memory holds its bf16 weights and its capped KV pool (less
    points to an earlier engine still alive; the bf16 weights exist in full
    before they are quantized), and checked to hold the capped pool.
    Returns (llm, facts of its sizing)."""
    import torch

    from ssd_tpu_torch import LLM
    from ssd_tpu_torch.config import ModelConfig
    from ssd_tpu_torch.engine.model_runner import kv_block_bytes
    from ssd_tpu_torch.models.transformer import Arch, param_bytes

    arch = Arch.from_model_config(ModelConfig(**QWEN3_30B_A3B))
    max_len, seqs = 2048, 8
    cap = (seqs + 1) * (max_len // BLOCK + 2) * 4          # the engine's pool cap
    need = param_bytes(arch, torch.bfloat16) + cap * kv_block_bytes(arch, BLOCK, torch.bfloat16)
    weights = param_bytes(arch, torch.bfloat16, quantization)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    if free < need:
        fail(f"moe: {free / 1e9:.2f} GB free at the start, but the weights and the "
             f"capped KV pool need {need / 1e9:.2f} GB: is an earlier phase's engine alive?")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        _write_config(d, QWEN3_30B_A3B)
        llm = LLM(d, init_random=True, dtype="bfloat16", gpu_memory_utilization=MOE_UTIL,
                  max_model_len=max_len, kvcache_block_size=BLOCK, max_num_seqs=seqs,
                  quantization=quantization)
    torch.cuda.synchronize()
    facts = dict(init_s=time.perf_counter() - t0, weights_gb=weights / 1e9,
                 free_at_start_gb=free / 1e9, total_gb=total / 1e9,
                 gpu_memory_utilization=MOE_UTIL, kv_blocks=llm.model_runner.num_kvcache_blocks,
                 cap_blocks=cap, pool=llm.model_runner.pool_sizing)
    if facts["kv_blocks"] < cap:
        fail(f"moe: the KV pool holds {facts['kv_blocks']} blocks, fewer than the cap's "
             f"{cap}: {facts['pool']}")
    return llm, facts


def phase_moe() -> dict:
    """Qwen3-30B-A3B at full width and depth through LLM(...).generate
    (module docstring, phase 6)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    V = QWEN3_30B_A3B["vocab_size"]
    llm, facts = _moe_llm()
    prompts8, prompt1 = _serving_prompts(V)
    warm = SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True)
    for eager in (False, True):   # warm-up: cuBLAS handles, allocator
        with _eager(llm) if eager else contextlib.nullcontext():
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    runs = _graph_vs_eager(llm, {"b8": (prompts8, sp)}, V, "moe", ("graph", "eager", "graph"))
    runs.update(_graph_vs_eager(llm, {"b1": (prompt1, sp)}, V, "moe",
                                ("graph", "eager", "graph")))
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("paged_attention", "flat_prefill_attention", "grouped_gemm")}
    emit("moe", geometry=MOE_GEOMETRY, **facts, graphs=_graph_facts(llm), launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if not all(n > 0 for n in launches.values()):
        fail(f"moe: a kernel of the path never launched: {launches}")
    for name, r in runs.items():
        if not r["tokens_equal"]:
            fail(f"moe {name}: graph and eager greedy tokens differ")
        if not r["graph_replays_per_decode_step"] > 0:
            fail(f"moe {name}: no graph replayed")
    facts["graphs"] = _graph_facts(llm)
    llm.exit()
    del llm
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, **facts}


# ---------------------------------------------------------------------------
# Phase 7: int8 weights (quantization="int8") at full width
# ---------------------------------------------------------------------------

QUANT_TURNS = ("graph", "eager", "graph")   # graph and eager in turns, one engine
QUANT_EAGER_NEW = 64   # tokens of an eager turn (half the graph turns', to hold the run's time)


def _int8_engine_facts(llm, label: str, init_s: float) -> dict:
    """Init seconds, each runner's weight bytes, the target's pool and
    graphs; fails if a runner holds an LM head that is not int8 (an fp32
    copy would mean the int8 head was widened at load)."""
    import torch

    heads = [r.params["lm_head"].dtype for r in _runners(llm)]
    if any(h != torch.int8 for h in heads):
        fail(f"quant {label}: the runners' LM heads are {heads}, not all int8")
    mr = llm.model_runner
    return dict(init_s=init_s, weight_bytes=[r.weight_bytes for r in _runners(llm)],
                kv_blocks=mr.num_kvcache_blocks, pool=mr.pool_sizing, graphs=_graph_facts(llm))


def _check_int8_run(label: str, run: dict, need: tuple, graph: bool = True):
    """K9 and the path's attention kernels launched, K6 never (int8 experts
    take K9), and a graph run replayed graphs."""
    launches = run["launches"]
    missing = [k for k in ("int8_linear",) + need if not launches[k] > 0]
    if missing or launches["grouped_gemm"]:
        fail(f"quant {label}: kernels that never launched {missing}, or K6 launched "
             f"{launches['grouped_gemm']} times: {launches}")
    if graph and not run["graph_replays_per_decode_step"] > 0:
        fail(f"quant {label}: no graph replayed")


def phase_quant(serve: dict | None, spec: dict | None, moe_run: dict | None) -> dict:
    """int8 weights at full width and depth (module docstring, phase 7)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    warm = SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True)
    attn = ("paged_attention", "flat_prefill_attention")
    out = {"engines": {}, "launches": {}}
    prompts8, prompt1 = _serving_prompts()

    def graph_vs_eager(llm, label, V, prompts8, prompt1):
        for eager in (False, True):   # warm-up
            with _eager(llm) if eager else contextlib.nullcontext():
                llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
        runs = _graph_vs_eager(llm, {"b8": (prompts8, sp), "b1": (prompt1, sp)}, V, label,
                               QUANT_TURNS, eager_new=QUANT_EAGER_NEW)
        for name, r in runs.items():
            if not r["tokens_equal"]:
                fail(f"{label} {name}: graph and eager greedy tokens differ")
            _check_int8_run(f"{label} {name}", r, attn)
            _check_int8_run(f"{label} {name} eager", {**r, "launches": r["launches_eager"]},
                            attn, graph=False)
        return runs

    # Llama-3.2-1B AR, the serve engine's geometry.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = _serving_llm(quantization="int8")
    torch.cuda.synchronize()
    facts = _int8_engine_facts(llm, "ar", time.perf_counter() - t0)
    runs = graph_vs_eager(llm, "quant_ar", LLAMA_1B["vocab_size"], prompts8, prompt1)
    facts.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                 bf16_pool=(serve or {}).get("pool"))
    out["engines"]["ar"] = dict(facts, runs=runs)
    out["launches"]["quant_ar"] = {k: sum(r["launches"][k] for r in runs.values())
                                   for k in ("int8_linear",) + attn}
    emit("quant", engine="ar", geometry="Llama-3.2-1B (16 layers, random bf16 weights "
         "quantized to int8 at load)", **facts)
    del llm
    torch.cuda.empty_cache()

    # Fused sync SD (R = SPEC_R) and unfused async SSD at b8 under graphs,
    # spec's pair at noise 0, target and draft both int8.
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN, kvcache_block_size=BLOCK,
                      max_num_seqs=8, quantization="int8")
        for mode in (f"fused{SPEC_R}", "ssd"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            llm = _spec_llm(tdir, ddir, mode, **engine)
            facts = _int8_engine_facts(llm, mode, time.perf_counter() - t0)
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
            run, _ = _spec_run(llm, mode, prompts8, 128)
            _check_int8_run(f"{mode} b8", run, attn + (("tree_attention",) if mode == "ssd"
                                                       else ()))
            bf16 = ((spec or {}).get("runs") or {}).get(f"{mode}_b8_noise0", {})
            facts.update(b8=run, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                         bf16_decode_tok_s=bf16.get("decode_tok_s"))
            out["engines"][mode] = facts
            out["launches"][f"quant_{mode}"] = {k: v for k, v in run["launches"].items() if v}
            emit("quant", engine=mode, geometry="Llama-3.2-1B width, target 16 "
                 "layers (4 live), draft 4 layers, int8 weights, noise 0", **facts)
            llm.exit()
            del llm
            torch.cuda.empty_cache()

    # Qwen3-30B-A3B at full depth, AR b8/b1: K9 over the experts, K6 never.
    llm, facts = _moe_llm(quantization="int8")
    facts.update(_int8_engine_facts(llm, "moe", facts["init_s"]))
    runs = graph_vs_eager(llm, "quant_moe", QWEN3_30B_A3B["vocab_size"],
                          *_serving_prompts(QWEN3_30B_A3B["vocab_size"]))
    facts.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                 bf16_pool=(moe_run or {}).get("pool"), bf16_weights_gb=(moe_run or {}).get(
                     "weights_gb"))
    out["engines"]["moe"] = dict(facts, runs=runs)
    out["launches"]["quant_moe"] = {k: sum(r["launches"][k] for r in runs.values())
                                    for k in ("int8_linear", "grouped_gemm") + attn}
    emit("quant", engine="moe", geometry=MOE_GEOMETRY + ", quantized to int8 at load", **facts)
    llm.exit()
    del llm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: EAGLE-3 async SSD at the Llama-3.1-8B geometry
# ---------------------------------------------------------------------------


def _eagle_config(d: str, **over):
    """An EAGLE-3 head's config.json (EAGLE3_8B, with `over`)."""
    _write_config(d, EAGLE3_8B, **over)


def _eagle_pair(d: str, layers: int, dtype, seed: int = 11, base: dict = LLAMA_8B):
    """bench.py::build_eagle_checkpoints at the width of `base`, in torch:
    a target whose layers are residual pass-throughs (o_proj = down = 0), so
    its last hidden state is the token's embedding, with unit-rms embeddings
    on the first Hkv*hd coordinates and an untied head that is the table
    rolled by one row (greedy walks t -> t-1); and a one-layer EAGLE head
    whose attention cancels the conditioning stream and replaces it with the
    token's normed embedding, so its logits equal the target's at every
    depth (noise 0 accepts ~K+1). Weights drawn on the card from a generator
    seeded with `seed`, stored in `dtype`. Returns (target dir, draft dir)."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = base
    D, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    Hq, Hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    G, S, beta = Hq // Hkv, Hkv * hd, 8.0
    g = torch.Generator(device="cuda").manual_seed(seed)

    def cpu(x):
        return x.to(dtype).cpu()

    def w(*shape):
        return cpu(torch.randn(*shape, generator=g, device="cuda") * 0.02)

    def ones(n):
        return torch.ones(n, dtype=dtype)

    e = torch.randn(V, S, generator=g, device="cuda")
    e *= D ** 0.5 / e.norm(dim=1, keepdim=True)
    emb = torch.zeros(V, D, device="cuda")
    emb[:, :S] = e
    head = torch.roll(emb, -1, dims=0)
    emb, head = cpu(emb), cpu(head)
    target = {"model.embed_tokens.weight": emb, "lm_head.weight": head,
              "model.norm.weight": ones(D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        target.update({
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": torch.zeros(D, Hq * hd, dtype=dtype),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": torch.zeros(D, I, dtype=dtype),
        })
    # The head's layer, HF [out, in]; its attention input is [norm(tok) | norm(cond)].
    r = torch.arange(Hq * hd)
    qw = torch.zeros(Hq * hd, 2 * D)
    qw[r, (r // hd // G) * hd + r % hd] = beta
    s = torch.arange(S)
    kw = torch.zeros(S, 2 * D)
    kw[s, s] = beta
    vw = torch.zeros(S, 2 * D)
    vw[s, s] = 1.0            # + the token's coordinates
    vw[s, D + s] = -1.0       # - the conditioning's (cancels the residual)
    ow = torch.zeros(D, Hq * hd)
    ow[s, (s // hd) * G * hd + s % hd] = 1.0   # one q head per group rebuilds v
    fc = torch.zeros(D, 3 * D)
    fc[torch.arange(D), torch.arange(D)] = 1.0  # the first tap
    draft = {
        "fc.weight": fc.to(dtype), "midlayer.self_attn.q_proj.weight": qw.to(dtype),
        "midlayer.self_attn.k_proj.weight": kw.to(dtype),
        "midlayer.self_attn.v_proj.weight": vw.to(dtype),
        "midlayer.self_attn.o_proj.weight": ow.to(dtype),
        "midlayer.mlp.gate_proj.weight": w(I, D), "midlayer.mlp.up_proj.weight": w(I, D),
        "midlayer.mlp.down_proj.weight": torch.zeros(D, I, dtype=dtype),
        "midlayer.input_layernorm.weight": ones(D), "midlayer.hidden_norm.weight": ones(D),
        "midlayer.post_attention_layernorm.weight": ones(D), "norm.weight": ones(D),
        "lm_head.weight": head, "embed_tokens.weight": emb,
    }
    dirs = []
    for name, tensors in (("target", target), ("draft", draft)):
        sub = os.path.join(d, name)
        os.makedirs(sub)
        save_safetensors(os.path.join(sub, "model.safetensors"), tensors)
        dirs.append(sub)
    _write_config(dirs[0], base, num_hidden_layers=layers, tie_word_embeddings=False)
    _eagle_config(dirs[1], draft_vocab_size=V, hidden_size=D, intermediate_size=I,
                  num_attention_heads=Hq, num_key_value_heads=Hkv, head_dim=hd)
    return tuple(dirs)


EAGLE_NOISE = ("fc", "wq", "wk", "wv", "wo")


def _perturb_eagle(llm, noise: float, originals: dict):
    """bench.py::build_eagle_checkpoints' draft_noise on the loaded head:
    each of fc, q, k, v, o becomes its constructed value plus noise times
    the rms of its nonzero entries times N(0, 1), drawn on the host from a
    generator seeded 2000 + index (so the card's and the CPU's heads are the
    same); an int8 head's per-channel scales s become s * (1 + noise *
    N(0, 1)). `originals` keeps the constructed values across calls."""
    import torch

    params = _draft_params(llm)
    for i, k in enumerate(EAGLE_NOISE):
        if k + "_scale" in params:
            # An int8 head: its per-channel scales times 1 + noise * N(0, 1).
            base = originals.setdefault(k + "_scale", params[k + "_scale"].clone())
            z = torch.randn(base.shape, generator=torch.Generator().manual_seed(2000 + i))
            params[k + "_scale"].copy_(base * (1 + noise * z.to(base.device)))
            continue
        base = originals.setdefault(k, params[k].clone())
        nz = base.float()[base != 0]
        rms = float(nz.pow(2).mean().sqrt()) if nz.numel() else 1.0
        z = torch.randn(base.shape, generator=torch.Generator().manual_seed(2000 + i))
        params[k].copy_(base + (noise * rms * z).to(base.device, base.dtype))
    torch.cuda.synchronize()


def _eagle_llm(tdir, ddir, init_random=False, form="ssd", **kw):
    """An EAGLE-3 engine: async SSD ("ssd": K=SPEC_K, fan-out SPEC_F, the
    head on the draft thread) or the fused sync superstep ("fused": SPEC_R
    rounds a step)."""
    from ssd_tpu_torch import LLM

    form_kw = (dict(draft_async=True, jit_speculate=True, async_fan_out=SPEC_F)
               if form == "ssd" else dict(spec_rounds=SPEC_R))
    return LLM(tdir, draft=ddir, speculate=True, use_eagle=True, speculate_k=SPEC_K,
               init_random=init_random, **form_kw, **kw)


def _eagle_room(n_new: int = 128) -> int:
    """The longest prompt the eagle phase serves: prompt + n_new + the tree
    lookahead (K+1 + K*MQ) fit the head's EAGLE_MAX_LEN positions."""
    return EAGLE_MAX_LEN - n_new - (SPEC_K + 1 + SPEC_K * SPEC_MQ)


def _eagle_lens() -> list[int]:
    """serve's b8 prompt lengths as the eagle phase serves them (only the
    1900-token prompt is cut, to _eagle_room())."""
    return [min(n, _eagle_room()) for n in SERVE_LENS8]


def _eagle_prompts(prompts: list[list[int]], n_new: int) -> list[list[int]]:
    return [p[:_eagle_room(n_new)] for p in prompts]


EAGLE_TURNS = ("graph", "eager")   # graph and eager in turns, one engine
EAGLE_EAGER_NEW = 64   # tokens of an eager turn (cut from 128 to hold the run's time)
# The eagle phase's engines: (path, kv_quant, form, {batch: turns}).
EAGLE_PLAN = (("ar", None, None, {"b8": ("graph",), "b1": ("graph",)}),
              ("eagle", None, "ssd", {"b8": EAGLE_TURNS, "b1": ("graph",)}),
              ("eagle_fused", None, "fused", {"b8": EAGLE_TURNS, "b1": ("graph",)}),
              ("eagle_int8", "int8", "ssd", {"b8": ("graph", "eager")}))


def phase_eagle() -> dict:
    """EAGLE-3 async SSD and the fused sync superstep at the Llama-3.1-8B
    geometry (module docstring, phase 8)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    V = LLAMA_8B["vocab_size"]
    p8, p1 = _serving_prompts(V)
    prompts = {"b8": _eagle_prompts(p8, 128), "b1": _eagle_prompts(p1, 128)}
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    engine = dict(dtype="bfloat16", max_model_len=EAGLE_MAX_LEN, kvcache_block_size=BLOCK,
                  max_num_seqs=8)
    out = {"runs": {}, "turns": {}, "graphs": {}}
    need = {"ar": ("paged_attention", "flat_prefill_attention"),
            "eagle": ("paged_attention", "flat_prefill_attention", "tree_attention"),
            "eagle_fused": ("paged_attention", "flat_prefill_attention"),
            "eagle_int8": ("paged_attention_int8", "flat_prefill_attention_int8",
                           "tree_attention_int8")}
    mode_of = {"ar": "ar", "eagle": "ssd", "eagle_int8": "ssd", "eagle_fused": f"fused{SPEC_R}"}

    def measured(llm, key, path, ps, n_new=128, eager=False):
        t0 = time.perf_counter()
        run, toks = _spec_run(llm, mode_of[path], ps, n_new, V=V, eager=eager)
        run["wall_incl_checks_s"] = time.perf_counter() - t0
        emit("eagle", run=key, eager=eager, **run)
        missing = [k for k in need[path] if run["launches"][k] <= 0]
        if missing:
            fail(f"eagle {key}: kernels of the path never launched {missing}: {run['launches']}")
        if path == "eagle_fused" and run["launches"]["tree_attention"]:
            fail(f"eagle {key}: the fused superstep launched the tree kernel")
        if not eager and not run["graph_replays_per_decode_step"] > 0:
            fail(f"eagle {key}: no graph replayed")
        if path != "ar":
            # Each prefill step launches K1 once per target layer and once
            # for the head's conditioned prefill.
            per_step = llm.model_runner.arch.num_layers + 1
            if run["launches"][need[path][1]] % per_step:
                fail(f"eagle {key}: {run['launches'][need[path][1]]} prefill launches are "
                     f"not whole steps of {per_step} (target layers + the head)")
        return run, toks

    def in_turns(llm, path, name, turns):
        """The turns' runs on one engine: the first graph and eager runs
        under their own keys, then decode tok/s (min / median / max), hit
        rate and accepted length of every run. The EAGLE target recomputes
        every prompt whole (its taps), so graph and eager tokens agree from
        the first run on (an eager turn's EAGLE_EAGER_NEW tokens with the
        graph turns' first ones)."""
        runs, toks = {"graph": [], "eager": []}, []
        for kind in turns:
            key = f"{path}_{name}" + ("_eager" if kind == "eager" else "")
            run, t = measured(llm, key, path, prompts[name], eager=kind == "eager",
                              n_new=EAGLE_EAGER_NEW if kind == "eager" else 128)
            if not runs[kind]:
                out["runs"][key] = run
            runs[kind].append(run)
            toks.append(t)
        g = runs["graph"][0]
        summary = dict(
            decode_tok_s={k: _spread([r["decode_tok_s"] for r in v]) for k, v in runs.items() if v},
            cache_hit_rate={k: [r.get("cache_hit_rate") for r in v] for k, v in runs.items() if v},
            mean_accepted_suffix_len={k: [r.get("mean_accepted_suffix_len") for r in v]
                                      for k, v in runs.items() if v},
            graph_replays_per_decode_step=g["graph_replays_per_decode_step"],
            launches_per_decode_step={k: n / g["decode_steps"]
                                      for k, n in g["launches"].items() if n},
            tokens_equal=all(a[:len(b)] == b[:len(a)] for x in toks
                             for a, b in zip(x, toks[0])))
        out["turns"][f"{path}_{name}"] = summary
        emit("eagle", turns=f"{path}_{name}", **summary)
        if not summary["tokens_equal"]:
            fail(f"eagle {path}_{name}: graph and eager greedy tokens differ")

    with tempfile.TemporaryDirectory() as d:
        tdir, edir = os.path.join(d, "t"), os.path.join(d, "e")
        os.makedirs(tdir)
        os.makedirs(edir)
        _write_config(tdir, LLAMA_8B)
        _eagle_config(edir)
        # Full depth, random bf16 weights (the same seeded target each time).
        for path, kvq, form, batches in EAGLE_PLAN:
            t0 = time.perf_counter()
            if form is None:
                from ssd_tpu_torch import LLM

                llm = LLM(tdir, init_random=True, **engine)
            else:
                llm = _eagle_llm(tdir, edir, init_random=True, form=form, kv_quant=kvq,
                                 **engine)
            torch.cuda.synchronize()
            out["graphs"][path] = dict(_graph_facts(llm), init_s=time.perf_counter() - t0)
            emit("eagle", engine=path, **out["graphs"][path])
            for eager in (False, True):
                with _eager(llm) if eager else contextlib.nullcontext():
                    llm.generate([p[:40] for p in prompts["b8"][:2]], warm, use_tqdm=False)
            for name, turns in batches.items():
                in_turns(llm, path, name, turns)
            out.setdefault("pools", {})[path] = llm.model_runner.pool_sizing
            out.setdefault("kv_blocks", {})[path] = llm.model_runner.num_kvcache_blocks
            llm.exit()
            del llm
            torch.cuda.empty_cache()

    # The constructed pair (target cut to EAGLE_PAIR_LAYERS layers): at
    # noise 0 both forms must accept near K+1 and async SSD hit the tree
    # cache; one level of a fixed ladder must land async SSD's hit rate in
    # MISS_HIT_RATE.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tdir, edir = _eagle_pair(d, EAGLE_PAIR_LAYERS, torch.bfloat16)
        out["pair_checkpoints_s"] = time.perf_counter() - t0
        for form, path in (("fused", "eagle_fused"), ("ssd", "eagle")):
            llm = _eagle_llm(tdir, edir, form=form, **engine)
            llm.generate([p[:40] for p in prompts["b8"][:2]], warm, use_tqdm=False)
            key = "pair_fused_noise0_b8" if form == "fused" else "pair_noise0_b8"
            run, _ = measured(llm, key, path, prompts["b8"])
            out["runs"][key] = run
            if run["mean_accepted_suffix_len"] < SPEC_K or \
                    (form == "ssd" and run["cache_hit_rate"] <= 0.9):
                fail(f"eagle {key}: the constructed pair at noise 0 accepted "
                     f"{run['mean_accepted_suffix_len']} (K+1 = {SPEC_K + 1}) with hit rate "
                     f"{run.get('cache_hit_rate')}")
            if form == "fused":
                llm.exit()
                del llm
                torch.cuda.empty_cache()
        originals, found = {}, None
        lo, hi = MISS_HIT_RATE
        for level in EAGLE_NOISE_LADDER:
            _perturb_eagle(llm, level, originals)
            key = f"pair_noise{level:g}_b8"
            run, _ = measured(llm, key, "eagle", prompts["b8"], 64)
            run["draft_noise"] = level
            out["runs"][key] = run
            if lo <= run["cache_hit_rate"] <= hi:
                found = level
                break
        if found is None:
            fail(f"eagle: no draft noise of {EAGLE_NOISE_LADDER} put the hit rate in "
                 f"[{lo}, {hi}]")
        out["miss_noise"] = found
        llm.exit()
        del llm
        torch.cuda.empty_cache()
    emit("eagle", geometry=EAGLE_GEOMETRY, K=SPEC_K, async_fan_out=SPEC_F, rounds=SPEC_R,
         max_model_len=EAGLE_MAX_LEN, pair_layers=EAGLE_PAIR_LAYERS, miss_noise=found,
         pools=out["pools"], kv_blocks=out["kv_blocks"], graphs=out["graphs"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


# ---------------------------------------------------------------------------
# Phase 9
# ---------------------------------------------------------------------------


REDUCED_ROWS = 16384   # the exact phase's reduced draft head (1/8 of Llama-3's vocabulary)


def _reduced_draft(d: str, ddir: str, emitted: list[list[int]]) -> str:
    """A reduced-vocabulary copy of the draft checkpoint ddir under d: an
    explicit lm_head of REDUCED_ROWS rows of the (tied) embedding, the
    tokens in `emitted` and a seeded fill (FR-Spec keeps the frequent
    tokens), and d2t (row i scores token i + d2t[i])."""
    import numpy as np
    import torch

    from ssd_tpu_torch.utils.loader import SafetensorsIndex, save_safetensors

    index = SafetensorsIndex(ddir)
    t = {name: index.get(name) for name in index.names()}
    V = t["model.embed_tokens.weight"].shape[0]
    keep = np.unique(np.concatenate([np.asarray(x, np.int64) for x in emitted]))
    rest = np.setdiff1d(np.arange(V), keep)
    fill = np.random.default_rng(6).choice(rest, REDUCED_ROWS - len(keep), replace=False)
    sub = np.sort(np.concatenate([keep, fill]))
    t["lm_head.weight"] = t["model.embed_tokens.weight"][torch.from_numpy(sub)].contiguous()
    t["d2t"] = torch.from_numpy((sub - np.arange(len(sub))).astype(np.int32))
    out = os.path.join(d, "reduced")
    os.makedirs(out)
    save_safetensors(os.path.join(out, "model.safetensors"), t)
    with open(os.path.join(ddir, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(dict(cfg, tie_word_embeddings=False), f)
    return out


def _random_checkpoint(d: str, layers: int, scale: float, seed: int):
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = LLAMA_1B
    D, I, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * scale

    t = {"model.embed_tokens.weight": w(c["vocab_size"], D),
         "model.norm.weight": torch.ones(D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": torch.ones(D),
            p + "post_attention_layernorm.weight": torch.ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I),
        })
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    _write_config(d, num_hidden_layers=layers)


def _moe_checkpoint(d: str, layers: int, scale: float, seed: int):
    """A Qwen3-30B-A3B-width checkpoint of `layers` layers: weights
    N(0, 1) * scale drawn on the card from a generator seeded with `seed`,
    stored in bf16 (half the file; the engines load them as fp32), norms at
    one, an untied head."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = QWEN3_30B_A3B
    D, Im, E = c["hidden_size"], c["moe_intermediate_size"], c["num_experts"]
    Hq, Hkv, hd = QWEN_HEADS
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    t = {"model.embed_tokens.weight": w(c["vocab_size"], D), "model.norm.weight": ones(D),
         "lm_head.weight": w(c["vocab_size"], D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd),
            p + "self_attn.q_norm.weight": ones(hd),
            p + "self_attn.k_norm.weight": ones(hd),
            p + "mlp.gate.weight": w(E, D),
        })
        for e in range(E):
            q = f"{p}mlp.experts.{e}."
            t.update({q + "gate_proj.weight": w(Im, D), q + "up_proj.weight": w(Im, D),
                      q + "down_proj.weight": w(D, Im)})
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    _write_config(d, c, num_hidden_layers=layers)


def _record_router_margins(margins: list):
    """Until the returned undo is called, append to `margins` the smallest
    gap between the k-th and (k+1)-th router logit of every MoE layer call
    (how close the expert choice came to a tie)."""
    import torch

    from ssd_tpu_torch.ops import moe

    orig = moe.route

    def recording(x, router, top_k, norm_topk_prob):
        top = torch.sort((x @ router).float(), dim=-1, descending=True).values
        margins.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return orig(x, router, top_k, norm_topk_prob)

    moe.route = recording
    return lambda: setattr(moe, "route", orig)


def _record_margins(llm, margins: list):
    """Append the smallest top-1/top-2 logit gap of every AR step's batch to
    `margins` (how close greedy decoding came to a tie)."""
    run = llm.model_runner.run

    def recording_run(seqs, is_prefill):
        toks, logits = run(seqs, is_prefill, return_logits=True)
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return toks

    llm.model_runner.run = recording_run


def phase_exact() -> dict:
    import numpy as np
    import torch

    from ssd_tpu_torch import LLM, SamplingParams

    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, LLAMA_1B["vocab_size"], size=n).tolist()
               for n in (20, 77, 130)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True)
    tokens, margins = {}, []
    with tempfile.TemporaryDirectory() as d:
        _random_checkpoint(d, layers=2, scale=0.4, seed=3)
        for dev in ("cuda", "cpu"):
            llm = LLM(d, device=dev, dtype="float32", max_model_len=512,
                      kvcache_block_size=BLOCK, max_num_seqs=4,
                      num_kvcache_blocks=32)
            _record_margins(llm, margins)
            outs, _ = llm.generate(prompts, sp, use_tqdm=False)
            tokens[dev] = [o["token_ids"] for o in outs]
            del llm
    equal = tokens["cuda"] == tokens["cpu"]
    emit("exact", geometry="Llama-3.2-1B width, 2 layers, fp32, init scale 0.4",
         prompts=[len(p) for p in prompts], new_tokens=16, equal=equal,
         min_top2_margin=min(margins),
         first_diff=None if equal else [
             (i, a, b) for i, (a, b) in enumerate(zip(tokens["cuda"], tokens["cpu"])) if a != b][:1])
    if not equal:
        fail("exact: greedy tokens on the card differ from the CPU's")

    # Speculative modes: target 3 layers (2 live; cut from 8, then 4, to
    # hold the run's time: a dead layer is an exact pass-through), a
    # 2-layer draft with noise, so steps both accept and
    # reject; every mode on both devices must give the card's eager AR
    # tokens, over the fp32 cache and over the int8 cache (whose AR is the
    # reference of its own modes; its AR runs record their top-1/top-2
    # margins). On the card every mode but ar_eager runs its CUDA graphs;
    # the CPU runs AR over each cache (its SD and SSD were cut to hold the
    # run's time: the card's modes equal the card's eager AR, which equals
    # the CPU's). Then two card runs of int8_mxu AR must agree.
    spec_tokens, accepted, hit_rates, int8_margins, seconds = {}, {}, {}, [], {}
    k9_launches = {}   # K9's launches in the int8-weight runs, per run
    engine = dict(dtype="float32", max_model_len=512, kvcache_block_size=BLOCK,
                  max_num_seqs=4, num_kvcache_blocks=32)
    new_modes = ("multi", "fused4", "ngram")
    async_modes = ("ssd", "fasync1", "fasync4")
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=3, live=2, scale=0.4, dtype=torch.float32, seed=3)
        for kvq in (None, "int8"):
            for dev in ("cuda", "cpu"):
                # The CPU runs the modes it ran before graphs; the card's new
                # modes are held to the card's eager AR, itself held to the
                # CPU's.
                modes = (("ar_eager", "ar") + (() if kvq else new_modes) + ("sd",) + async_modes
                         + (() if kvq else ("ssd_dp2",)) if dev == "cuda" else ("ar",))
                for mode in modes:
                    t0 = time.perf_counter()
                    if mode in ("ar", "ar_eager", "multi"):
                        llm = LLM(tdir, device=dev, kv_quant=kvq, enforce_eager=mode == "ar_eager",
                                  multi_step=SERVE_M if mode == "multi" else 1, **engine)
                        if kvq and mode == "ar_eager":
                            _record_margins(llm, int8_margins)
                    elif mode == "ngram":
                        llm = _spec_llm(tdir, None, mode, device=dev, kv_quant=kvq, **engine)
                    else:
                        llm = _spec_llm(tdir, ddir, mode, device=dev, kv_quant=kvq, **engine)
                        _perturb_draft(llm, 0.01, 0.4)
                    outs, m = llm.generate(prompts, sp, use_tqdm=False)
                    llm.exit()
                    if dev == "cuda" and mode != "ar_eager" and llm.graphs is None:
                        fail(f"exact: the card's {kvq or 'fp32'} {mode} engine holds no graphs")
                    spec_tokens[(kvq or "fp32", dev, mode)] = [o["token_ids"] for o in outs]
                    run = f"{kvq or 'fp32'}_{dev}_{mode}"
                    seconds[run] = time.perf_counter() - t0
                    lens = m["accepted_suffix_lens_with_recovery"]
                    accepted[run] = sum(lens) / len(lens) if lens else None
                    if m["cache_hits"]:
                        hit_rates[run] = sum(m["cache_hits"]) / len(m["cache_hits"])
                    del llm
        # The reduced-vocabulary draft (FR-Spec style): the draft with an
        # explicit head of REDUCED_ROWS rows (the card's fp32 AR tokens and
        # a seeded fill) and d2t; sync SD, fused SD and unfused SSD under
        # graphs equal the card's eager AR ("reduced").
        rdir = _reduced_draft(d, ddir, spec_tokens[("fp32", "cuda", "ar_eager")])
        for mode in ("sd", "fused4", "ssd"):
            t0 = time.perf_counter()
            llm = _spec_llm(tdir, rdir, mode, device="cuda", **engine)
            _perturb_draft(llm, 0.01, 0.4)
            rows = _draft_params(llm)["lm_head"].shape[0]
            outs, m = llm.generate(prompts, sp, use_tqdm=False)
            llm.exit()
            if llm.graphs is None or rows != REDUCED_ROWS:
                fail(f"exact: the reduced-vocabulary {mode} engine holds no graphs, or "
                     f"a head of {rows} rows")
            spec_tokens[("reduced", "cuda", mode)] = [o["token_ids"] for o in outs]
            run = f"reduced_cuda_{mode}"
            seconds[run] = time.perf_counter() - t0
            lens = m["accepted_suffix_lens_with_recovery"]
            accepted[run] = sum(lens) / len(lens) if lens else None
            if m["cache_hits"]:
                hit_rates[run] = sum(m["cache_hits"]) / len(m["cache_hits"])
            del llm
        mxu = []
        for _ in range(2):
            llm = LLM(tdir, device="cuda", kv_quant="int8_mxu", **engine)
            mxu.append([o["token_ids"] for o in llm.generate(prompts, sp, use_tqdm=False)[0]])
            del llm
        # int8 weights (quantization="int8", fp32 engines, the draft's
        # scales perturbed): the card's graph AR, SD and SSD and the CPU's
        # AR equal the card's eager AR of the same weights ("int8w").
        for dev, mode in (("cuda", "ar_eager"), ("cuda", "ar"), ("cuda", "sd"),
                          ("cuda", "ssd"), ("cpu", "ar")):
            t0 = time.perf_counter()
            if mode in ("ar", "ar_eager"):
                llm = LLM(tdir, device=dev, quantization="int8",
                          enforce_eager=mode == "ar_eager", **engine)
            else:
                llm = _spec_llm(tdir, ddir, mode, device=dev, quantization="int8", **engine)
                _perturb_draft(llm, 0.01, 0.4)
            for w in _kernel_wrappers():
                w.launches = 0
            outs, m = llm.generate(prompts, sp, use_tqdm=False)
            if mode == "ssd":
                llm.draft_server.drain()
            if dev == "cuda":
                k9_launches[f"1b_{mode}"] = _kernel_wrappers()[-1].launches
            llm.exit()
            spec_tokens[("int8w", dev, mode)] = [o["token_ids"] for o in outs]
            run = f"int8w_{dev}_{mode}"
            seconds[run] = time.perf_counter() - t0
            lens = m["accepted_suffix_lens_with_recovery"]
            accepted[run] = sum(lens) / len(lens) if lens else None
            if m["cache_hits"]:
                hit_rates[run] = sum(m["cache_hits"]) / len(m["cache_hits"])
            del llm
    spec_equal = {f"{kvq}_{dev}_{mode}": toks == spec_tokens[
        ("fp32" if kvq == "reduced" else kvq, "cuda", "ar_eager")]
                  for (kvq, dev, mode), toks in spec_tokens.items()}
    int8_vs_fp32 = sum(a == b for x, y in zip(spec_tokens[("int8", "cuda", "ar_eager")],
                                              spec_tokens[("fp32", "cuda", "ar_eager")])
                       for a, b in zip(x, y))
    emit("exact", geometry="Llama-3.2-1B width, target 3 layers (2 live), draft 2 layers "
         "(noise 0.01), fp32, init scale 0.4", K=SPEC_K, async_fan_out=SPEC_F,
         equal_to_card_ar_of_same_cache=spec_equal, mean_accepted_suffix_len=accepted,
         cache_hit_rate=hit_rates, seconds=seconds,
         int8_min_top2_margin=min(int8_margins),
         int8_ar_tokens_equal_to_fp32_ar=int8_vs_fp32, tokens_per_run=16 * len(prompts),
         int8_weights_k9_launches=k9_launches,
         int8_mxu_two_card_runs_equal=mxu[0] == mxu[1])
    if not all(spec_equal.values()):
        fail(f"exact: greedy tokens differ from the card's eager AR of the same cache: "
             f"{spec_equal}")
    if mxu[0] != mxu[1]:
        fail("exact: two card runs of int8_mxu gave different tokens")

    # Qwen3-MoE at the Qwen3-30B-A3B width, 1 layer, fp32: AR on the CPU,
    # graph AR, sync SD (graphs) and async SSD on the card (self-draft)
    # equal the card's eager AR; the grouped GEMM launches in each card run.
    t_moe = time.perf_counter()
    mprompts = [rng.integers(3, QWEN3_30B_A3B["vocab_size"], size=n).tolist()
                for n in (20, 77, 130)]
    moe_tokens, moe_margins, router_margins, moe_launches, moe_accepted = {}, [], [], {}, {}
    wrappers = _kernel_wrappers()
    with tempfile.TemporaryDirectory() as d:
        # One layer (cut from two to hold the run's time).
        _moe_checkpoint(d, layers=1, scale=0.4, seed=5)
        # "_int8w": int8 weights, held to the card's eager AR of the same
        # weights.
        for dev, mode in (("cuda", "ar_eager"), ("cpu", "ar"), ("cuda", "ar"), ("cuda", "sd"),
                          ("cuda", "ssd"), ("cuda", "ar_eager_int8w"), ("cpu", "ar_int8w"),
                          ("cuda", "ar_int8w")):
            quant = "int8" if mode.endswith("_int8w") else None
            mode_q, mode = mode, mode.removesuffix("_int8w")
            # The margins are read on the host, so only the eager runs
            # record them (a graph's capture must read nothing back).
            eager = dev == "cpu" or mode == "ar_eager"
            undo = _record_router_margins(router_margins) if eager else (lambda: None)
            try:
                if mode in ("ar", "ar_eager"):
                    llm = LLM(d, device=dev, enforce_eager=mode == "ar_eager",
                              quantization=quant, **engine)
                    if eager:
                        _record_margins(llm, moe_margins)
                else:
                    llm = _spec_llm(d, d, mode, device=dev, **engine)
                for w in wrappers:
                    w.launches = 0
                outs, m = llm.generate(mprompts, sp, use_tqdm=False)
                if mode == "ssd":
                    llm.draft_server.drain()
                moe_launches[f"{dev}_{mode_q}"] = {w.__name__: w.launches for w in wrappers}
                llm.exit()
            finally:
                undo()
            moe_tokens[(dev, mode_q)] = [o["token_ids"] for o in outs]
            lens = m["accepted_suffix_lens_with_recovery"]
            moe_accepted[f"{dev}_{mode_q}"] = sum(lens) / len(lens) if lens else None
            del llm
    moe_equal = {f"{dev}_{mode}": toks == moe_tokens[
        ("cuda", "ar_eager_int8w" if mode.endswith("_int8w") else "ar_eager")]
        for (dev, mode), toks in moe_tokens.items()}
    emit("exact", geometry="Qwen3-30B-A3B width (128 experts, top-8, hd 128), 1 layer, "
         "fp32, init scale 0.4; SD/SSD self-draft", K=SPEC_K, async_fan_out=SPEC_F,
         equal_to_card_ar=moe_equal, mean_accepted_suffix_len=moe_accepted,
         seconds=time.perf_counter() - t_moe,
         min_top2_margin=min(moe_margins), min_router_kth_margin=min(router_margins),
         grouped_gemm_launches={k: v["grouped_gemm"] for k, v in moe_launches.items()},
         launches=moe_launches)
    if not all(moe_equal.values()):
        fail(f"exact: Qwen3-MoE greedy tokens differ from the card's AR: {moe_equal}")
    if not all(v["grouped_gemm"] > 0 and not v["int8_linear"]
               for k, v in moe_launches.items() if k.startswith("cuda") and "int8w" not in k):
        fail(f"exact: the grouped GEMM did not launch in a card run: {moe_launches}")
    if not all(v["int8_linear"] > 0 and not v["grouped_gemm"]
               for k, v in moe_launches.items() if k.startswith("cuda") and "int8w" in k):
        fail(f"exact: K9 did not launch, or K6 did, in an int8-weight card run: {moe_launches}")

    # EAGLE-3 at the width of the checks above (Llama-3.2-1B), 2 layers,
    # fp32: the constructed pair (stored bf16, loaded fp32) with draft noise
    # EXACT_EAGLE_NOISE, so steps both accept and reject. Over the fp32 and
    # the int8 cache, async EAGLE SSD and the fused superstep (SPEC_R rounds)
    # under the card's graphs, and the CPU's AR, equal the card's eager AR of
    # the same cache (the CPU's EAGLE runs were cut to hold the run's time).
    t_eagle = time.perf_counter()
    eprompts = [rng.integers(3, LLAMA_1B["vocab_size"], size=n).tolist() for n in (20, 77, 130)]
    e_tokens, e_accepted, e_hits, e_margins, e_seconds = {}, {}, {}, [], {}
    with tempfile.TemporaryDirectory() as d:
        tdir, edir = _eagle_pair(d, 2, torch.bfloat16, seed=13, base=LLAMA_1B)
        # "int8w": int8 weights (target and head; the head computes in
        # bf16), over the fp32 cache.
        for kvq, quant in ((None, None), ("int8", None), (None, "int8")):
            runs = (("cuda", "ar_eager"), ("cpu", "ar"), ("cuda", "ssd"), ("cuda", "fused"))
            tag = "int8w" if quant else kvq or "fp32"
            for dev, mode in runs:
                t0 = time.perf_counter()
                if mode in ("ar", "ar_eager"):
                    llm = LLM(tdir, device=dev, kv_quant=kvq, enforce_eager=mode == "ar_eager",
                              quantization=quant, **engine)
                    _record_margins(llm, e_margins)
                else:
                    # Taps of the 2-layer target (its layers pass the
                    # embedding through, so every tap is the embedding).
                    llm = _eagle_llm(tdir, edir, device=dev, form=mode, kv_quant=kvq,
                                     quantization=quant, eagle_layers=[0, 1, 1], **engine)
                    _perturb_eagle(llm, EXACT_EAGLE_NOISE, {})
                for w in _kernel_wrappers():
                    w.launches = 0
                outs, m = llm.generate(eprompts, sp, use_tqdm=False)
                if mode == "ssd":
                    llm.draft_server.drain()
                if quant and dev == "cuda":
                    k9_launches[f"eagle_{mode}"] = _kernel_wrappers()[-1].launches
                llm.exit()
                if dev == "cuda" and mode != "ar_eager" and llm.graphs is None:
                    fail(f"exact: the card's {tag} EAGLE {mode} engine holds no graphs")
                key = f"{tag}_{dev}_{mode}"
                e_tokens[key] = [o["token_ids"] for o in outs]
                e_seconds[key] = time.perf_counter() - t0
                lens = m["accepted_suffix_lens_with_recovery"]
                e_accepted[key] = sum(lens) / len(lens) if lens else None
                e_hits[key] = (sum(m["cache_hits"]) / len(m["cache_hits"])
                               if m["cache_hits"] else None)
                del llm
    eagle_equal = {k: toks == e_tokens[f"{k.split('_')[0]}_cuda_ar_eager"]
                   for k, toks in e_tokens.items()}
    emit("exact", geometry="Llama-3.2-1B width, 2 layers, + the constructed EAGLE-3 head "
         f"(noise {EXACT_EAGLE_NOISE}), fp32", K=SPEC_K, async_fan_out=SPEC_F, rounds=SPEC_R,
         equal_to_card_ar_of_same_cache=eagle_equal, mean_accepted_suffix_len=e_accepted,
         cache_hit_rate=e_hits, min_top2_margin=min(e_margins), seconds=e_seconds,
         total_seconds=time.perf_counter() - t_eagle)
    if not all(eagle_equal.values()):
        fail(f"exact: EAGLE greedy tokens differ from the card's eager AR: {eagle_equal}")
    k9_launches.update({f"moe_{k}": v["int8_linear"] for k, v in moe_launches.items()
                        if "int8w" in k and k.startswith("cuda")})
    emit("exact", int8_weights_k9_launches=k9_launches)
    if not all(n > 0 for n in k9_launches.values()):
        fail(f"exact: K9 did not launch in an int8-weight card run: {k9_launches}")
    return {"equal": equal, "min_top2_margin": min(margins), "spec_equal": spec_equal,
            "moe_equal": moe_equal, "moe_launches": moe_launches, "eagle_equal": eagle_equal,
            "k9_launches": k9_launches}


# ---------------------------------------------------------------------------
# Phase tp
# ---------------------------------------------------------------------------


def _tp_prompts(V: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(4)
    return [rng.integers(3, V, size=n).tolist() for n in TP_LENS]


def _tp_mode_kw(mode: str, path: str) -> dict:
    """The engine arguments of a tp-phase mode, the target its own draft."""
    if mode == "ar":
        return {}
    spec = dict(draft=path, speculate=True, speculate_k=SPEC_K)
    if mode == f"fused{SPEC_R}":
        return dict(spec, spec_rounds=SPEC_R)
    return dict(spec, draft_async=True, async_fused=True, async_fan_out=SPEC_F)


def _tp_comm_counts() -> dict:
    from ssd_tpu_torch.parallel import comm

    return {"all_reduce_sum": comm.all_reduce_sum.launches,
            "gather_vocab": comm.gather_vocab.launches,
            "union_sum": comm.union_sum.launches}


def _tp_zero_counts():
    from ssd_tpu_torch.parallel import comm

    for w in _kernel_wrappers() + (comm.all_reduce_sum, comm.gather_vocab, comm.union_sum):
        w.launches = 0


def _tp_serve(llm, prompts, n_new: int) -> dict:
    """One greedy generate with every count zeroed just before and read
    just after: tokens, seconds, kernel launches, collectives, replays,
    the runner's heads."""
    import torch

    from ssd_tpu_torch import SamplingParams

    _tp_zero_counts()
    replays0 = _replays(llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, m = llm.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=n_new,
                                                   ignore_eos=True), use_tqdm=False)
    torch.cuda.synchronize()
    steps = max(1, len(m["target_step_times"]) - 1)
    a = llm.model_runner.arch
    return dict(tokens=[o["token_ids"] for o in outs], seconds=time.perf_counter() - t0,
                decode_steps=steps, graph_replays=_replays(llm) - replays0,
                launches={w.__name__: w.launches for w in _kernel_wrappers()},
                collectives=_tp_comm_counts(), heads=[a.num_heads, a.num_kv_heads],
                decode_tok_s=m["decode_total_tokens"] / max(m["decode_total_time"], 1e-9),
                cache_hits=[float(x) for x in m["cache_hits"]],
                accepted=[float(x) for x in m["accepted_suffix_lens_with_recovery"]])


def _tp_rank(rank: int, size: int, store: str, cases: list, out_path: str):
    """One rank of the tp phase's gloo group on the card (cuda:0, shared):
    every case's engine over the group, eagerly, each rank's generate
    identical; rank 0 writes what it served to out_path."""
    import gc

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size)
    try:
        from ssd_tpu_torch import LLM

        results = {}
        for key, path, V, kw in cases:
            t0 = time.perf_counter()
            llm = LLM(path, num_devices=size, device="cuda", enforce_eager=True, **kw)
            init_s = time.perf_counter() - t0
            results[key] = dict(_tp_serve(llm, _tp_prompts(V), TP_NEW), init_s=init_s)
            llm.exit()
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _tp_one_rank_nccl() -> dict:
    """The TP code on the card at world size 1 under graphs: the full-width,
    full-depth Llama-3.2-1B engines of AR and fused SD (random bf16 weights
    from a seed, the target its own draft) built over a one-rank NCCL group
    equal the same engines without a group bit for bit: greedy tokens at
    b8, and the logits of a decode (AR) or a verify (fused SD) forward over
    the 8 prefilled serve prompts. The collectives run inside the graph
    replays (counted through them); the engine without a group runs
    none."""
    import gc

    import torch
    import torch.distributed as dist

    from ssd_tpu_torch import LLM, SamplingParams

    prompts8, _ = _serving_prompts()
    engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN, kvcache_block_size=BLOCK,
                  max_num_seqs=8)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        _write_config(d)
        for mode in ("ar", f"fused{SPEC_R}"):
            res = {}
            for group in (False, True):
                if group:
                    dist.init_process_group("nccl", init_method=f"file://{d}/store_{mode}",
                                            rank=0, world_size=1)
                try:
                    t0 = time.perf_counter()
                    llm = LLM(d, init_random=True, **engine, **_tp_mode_kw(mode, d))
                    init_s = time.perf_counter() - t0
                    if (llm.comm is not None) != group or llm.graphs is None:
                        fail(f"tp: the {mode} engine's group or graphs are not as asked")
                    run = dict(_tp_serve(llm, prompts8, 64), init_s=init_s)
                    # A decode (AR) or verify (fused SD) forward of the target
                    # over the 8 prompts just prefilled, through its graph.
                    ids = [llm.add_request(p, SamplingParams(temperature=0.0, max_new_tokens=8,
                                                              ignore_eos=True))
                           for p in prompts8]
                    llm.step()
                    seqs = sorted(llm.scheduler.running, key=lambda s: s.seq_id)
                    if mode == "ar":
                        logits = llm.model_runner.run_decode(seqs)[1]
                    else:
                        logits = llm.model_runner.verify_forward(seqs, SPEC_K + 1)[0]
                    run["logits"] = logits.float().cpu()
                    for i in ids:
                        llm.abort_request(i)
                    llm.exit()
                    del llm
                    gc.collect()
                    torch.cuda.empty_cache()
                finally:
                    if group:
                        dist.destroy_process_group()
                res[group] = run
            plain, grp = res[False], res[True]
            out[mode] = dict(
                tokens_equal=plain["tokens"] == grp["tokens"],
                logits_equal=bool(torch.equal(plain["logits"], grp["logits"])),
                logits_shape=list(grp["logits"].shape),
                collectives_per_decode_step={k: v / grp["decode_steps"]
                                             for k, v in grp["collectives"].items()},
                collectives_without_group=plain["collectives"],
                graph_replays=grp["graph_replays"], decode_steps=grp["decode_steps"],
                seconds={"no_group": plain["seconds"], "group": grp["seconds"]},
                init_s={"no_group": plain["init_s"], "group": grp["init_s"]},
                launches=grp["launches"], launches_without_group=plain["launches"])
            emit("tp", part="nccl_world_size_1", mode=mode, **out[mode])
            if not (out[mode]["tokens_equal"] and out[mode]["logits_equal"]):
                fail(f"tp: the {mode} engine over a one-rank NCCL group differs from the "
                     "engine without a group")
            if grp["collectives"]["all_reduce_sum"] == 0 or grp["graph_replays"] == 0 \
                    or any(plain["collectives"].values()):
                fail(f"tp: {mode}: collectives {grp['collectives']} in "
                     f"{grp['graph_replays']} replays with the group, "
                     f"{plain['collectives']} without")
    return out


def phase_tp() -> dict:
    """Tensor and expert parallelism on one card (module docstring, phase
    tp)."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    out = {"nccl_world_size_1": _tp_one_rank_nccl(), "runs": {}}
    with tempfile.TemporaryDirectory() as d:
        ldir, qdir = os.path.join(d, "llama"), os.path.join(d, "qwen")
        os.makedirs(ldir)
        os.makedirs(qdir)
        _write_config(ldir, num_hidden_layers=4)
        _write_config(qdir, QWEN3_30B_A3B, num_hidden_layers=2)
        base = dict(init_random=True, max_model_len=1024, kvcache_block_size=BLOCK,
                    max_num_seqs=len(TP_LENS), num_kvcache_blocks=160)
        cases = []
        for model, path, V, plan in (
                ("llama1b_4l", ldir, LLAMA_1B["vocab_size"],
                 [("float32", "ar"), ("float32", f"fused{SPEC_R}"), ("float32", "fasync1"),
                  ("bfloat16", "ar")]),
                ("qwen3_30b_a3b_2l", qdir, QWEN3_30B_A3B["vocab_size"],
                 [("float32", "ar"), ("float32", f"fused{SPEC_R}"), ("bfloat16", "ar")])):
            for dt, mode in plan:
                cases.append((f"{model}_{dt}_{mode}", path, V,
                              dict(base, dtype=dt, **_tp_mode_kw(mode, path))))
        # TP = 1 on the card: the same engines, one process, eagerly.
        tp1 = {}
        for key, path, V, kw in cases:
            llm = LLM(path, enforce_eager=True, **kw)
            tp1[key] = _tp_serve(llm, _tp_prompts(V), TP_NEW)
            llm.exit()
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        # TP = 2: two processes sharing the card over gloo, eagerly.
        t0 = time.perf_counter()
        result = os.path.join(d, "tp2.json")
        codes = _spawn_group(_tp_rank, TP_RANKS, (os.path.join(d, "store"), cases, result),
                             timeout=900)
        if codes != [0] * TP_RANKS:
            fail(f"tp: the gloo ranks exited with {codes}")
        with open(result) as f:
            tp2 = json.load(f)
        out["tp2_seconds"] = time.perf_counter() - t0
        out["multi_card"] = torch.cuda.device_count() >= 2
        if out["multi_card"]:
            out["nccl_tp2"] = _tp_two_cards_nccl(cases, tp1)
        out["draft_rank"] = _tp_draft_rank(d, ldir)
    for key, _, _, kw in cases:
        a, b = tp1[key], tp2[key]
        steps = [next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
                 for ta, tb in zip(a["tokens"], b["tokens"])]
        agree = sum(x == y for ta, tb in zip(a["tokens"], b["tokens"]) for x, y in zip(ta, tb))
        run = dict(dtype=kw["dtype"], tokens_equal=a["tokens"] == b["tokens"],
                   tokens_agreeing=agree, tokens=TP_NEW * len(TP_LENS),
                   first_differing_step=steps, heads_tp1=a["heads"], heads_tp2=b["heads"],
                   launches_tp2_rank0=b["launches"], collectives_tp2_rank0=b["collectives"],
                   seconds_tp1=a["seconds"], seconds_tp2=b["seconds"], init_s_tp2=b["init_s"])
        out["runs"][key] = run
        emit("tp", part="gloo_tp2_one_card", case=key, **run)
        if kw["dtype"] == "float32" and not run["tokens_equal"]:
            fail(f"tp: {key}: fp32 greedy tokens at tp 2 differ from tp 1")
        need = ["flat_prefill_attention", "paged_attention"] + (
            ["tree_attention"] if key.endswith("fasync1") else []) + (
            ["grouped_gemm"] if key.startswith("qwen") else [])
        if not all(b["launches"][n] > 0 for n in need) or b["collectives"]["all_reduce_sum"] == 0:
            fail(f"tp: {key}: a kernel of the path or the all-reduce never ran at tp 2: "
                 f"{b['launches']}, {b['collectives']}")
    emit("tp", part="cards", device_count=torch.cuda.device_count(),
         ran=("NCCL world size 1 under graphs; gloo tp 2 on one card, eagerly; a draft "
              "rank beside the target on one card over gloo, eagerly"
              + ("; NCCL tp 2 and a draft rank on cuda:1 under graphs" if out["multi_card"]
                 else "; one card: NCCL tp 2 and the NCCL draft rank not run")))
    return out


def _draft_rank_case(ldir: str) -> dict:
    """The draft-rank part's engine: the 1B geometry at 4 layers, fp32
    async SSD, the target its own draft (random weights from a seed)."""
    return dict(init_random=True, max_model_len=1024, kvcache_block_size=BLOCK,
                max_num_seqs=len(TP_LENS), num_kvcache_blocks=160, dtype="float32",
                draft=ldir, speculate=True, speculate_k=SPEC_K, draft_async=True,
                async_fan_out=SPEC_F)


def _draft_rank_serve(llm) -> dict:
    """_tp_serve of a target whose draft runs on ranks of its own, with the
    draft ranks' launches (drained before and after: counts since the
    previous drain) and the exchange's seconds a decode step."""
    llm.draft_server.drain()
    n0 = len(llm.draft_server.exchange_s)
    run = _tp_serve(llm, _tp_prompts(LLAMA_1B["vocab_size"]), TP_NEW)
    run["draft_rank_launches"] = llm.draft_server.drain()
    ex = llm.draft_server.exchange_s[n0:]
    run["exchange_ms_per_step"] = 1e3 * sum(ex) / len(ex)
    run["ms_per_decode_step"] = 1e3 * run["seconds"] / run["decode_steps"]
    return run


def _draft_rank_proc(rank: int, store: str, ldir: str, out_path: str):
    """One process of the draft-rank part's gloo group on the card (cuda:0,
    shared): rank 0 the target, rank 1 its draft rank, each building the
    same engine over the group (rank 1's returns at the target's exit)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        from ssd_tpu_torch import LLM

        t0 = time.perf_counter()
        llm = LLM(ldir, num_devices=2, device="cuda", enforce_eager=True,
                  **_draft_rank_case(ldir))
        if rank == 1:
            return
        run = dict(_draft_rank_serve(llm), init_s=time.perf_counter() - t0,
                   tp_size=llm.config.tp_size, draft_ranks=llm.config.draft_ranks)
        llm.exit()
        with open(out_path, "w") as f:
            json.dump(run, f)
    finally:
        dist.destroy_process_group()


def _tp_draft_rank(d: str, ldir: str) -> dict:
    """The unfused async draft on a rank of its own: two processes on the
    one card over gloo (the target on cuda:0, its draft rank on cuda:0),
    eagerly; the greedy fp32 tokens equal the card's single-process SSD
    (eager), K1 and K2 launch in the target and K1, K2 and K3 in the draft
    rank. With two cards or more the engine spawns the draft rank on
    cuda:1 over NCCL under graphs, with the same tokens."""
    import gc
    import multiprocessing as mp

    import torch

    from ssd_tpu_torch import LLM

    llm = LLM(ldir, enforce_eager=True, **_draft_rank_case(ldir))
    one = _tp_serve(llm, _tp_prompts(LLAMA_1B["vocab_size"]), TP_NEW)
    llm.exit()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    result = os.path.join(d, "draft_rank.json")
    procs = [ctx.Process(target=_draft_rank_proc,
                         args=(r, os.path.join(d, "store_draft"), ldir, result))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    if codes != [0, 0]:
        fail(f"tp: the draft-rank processes exited with {codes}")
    with open(result) as f:
        run = json.load(f)
    out = {"gloo_one_card": dict(
        {k: v for k, v in run.items() if k != "tokens"},
        tokens_equal=run["tokens"] == one["tokens"], seconds_one_process=one["seconds"],
        ms_per_decode_step_one_process=1e3 * one["seconds"] / one["decode_steps"])}
    emit("tp", part="draft_rank", form="gloo, target and draft rank on cuda:0",
         **out["gloo_one_card"])
    if not out["gloo_one_card"]["tokens_equal"]:
        fail("tp: draft_rank: fp32 tokens with the draft on its own rank differ from the "
             "single-process SSD's")
    need_target, need_draft = ("flat_prefill_attention", "paged_attention"), \
        ("flat_prefill_attention", "paged_attention", "tree_attention")
    if not (all(run["launches"][k] > 0 for k in need_target)
            and all(run["draft_rank_launches"][k] > 0 for k in need_draft)
            and not run["launches"]["tree_attention"]):
        fail(f"tp: draft_rank: a kernel of the path did not launch where it runs: target "
             f"{run['launches']}, draft rank {run['draft_rank_launches']}")
    if torch.cuda.device_count() >= 2:
        out["nccl_two_cards"] = _draft_rank_nccl(ldir, one["tokens"])
    return out


def _draft_rank_nccl(ldir: str, want: list) -> dict:
    """With two cards: the engine spawns its draft rank on cuda:1 over NCCL,
    under graphs; the tokens must equal `want` (the single-process SSD's)."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    llm = LLM(ldir, num_devices=2, **_draft_rank_case(ldir))
    nccl = _draft_rank_serve(llm)
    llm.exit()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    out = dict({k: v for k, v in nccl.items() if k != "tokens"},
               tokens_equal=nccl["tokens"] == want)
    emit("tp", part="draft_rank", form="NCCL, draft rank on cuda:1, graphs", **out)
    if not out["tokens_equal"] or not nccl["graph_replays"]:
        fail("tp: draft_rank: the NCCL draft rank's tokens differ, or no graph replayed")
    return out


DRAFT_RANK_TURNS = ("beside", "rank", "rank", "beside", "beside", "rank")   # in turns


def phase_spec_draft_rank() -> dict:
    """Not run by default; needs two cards. The unfused async draft beside
    the target (one process, the draft thread on its own stream) against
    the draft on a rank of its own on cuda:1 (NCCL; both under graphs):
    first the tp phase's fp32 4-layer check of the NCCL draft rank (tokens
    equal the single-process SSD's), then spec's pair (bf16, the 1B width,
    a 16-layer target with 4 live layers, the 4-layer draft, K 4, fan-out
    2) at b8 and b1, noise 0, 128 tokens, both engines alive and run in
    turns (DRAFT_RANK_TURNS, three runs each): decode tok/s min / median /
    max, accepted length, hit rate, the exchange's ms a decode step, the
    draft rank's kernel launches; greedy tokens must agree across the
    forms over the runs that find the prompts in the prefix cache."""
    import gc

    import torch

    from ssd_tpu_torch import LLM, SamplingParams

    if torch.cuda.device_count() < 2:
        emit("spec_draft_rank", skipped="needs two cards",
             device_count=torch.cuda.device_count())
        return {}
    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as d:
        ldir = os.path.join(d, "llama")
        os.makedirs(ldir)
        _write_config(ldir, num_hidden_layers=4)
        llm = LLM(ldir, **_draft_rank_case(ldir))
        one = _tp_serve(llm, _tp_prompts(LLAMA_1B["vocab_size"]), TP_NEW)
        llm.exit()
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        out["nccl_exact"] = _draft_rank_nccl(ldir, one["tokens"])

        prompts8, prompt1 = _serving_prompts()
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN, kvcache_block_size=BLOCK,
                      max_num_seqs=8, num_kvcache_blocks=400, draft=ddir, speculate=True,
                      speculate_k=SPEC_K, draft_async=True, async_fan_out=SPEC_F)
        llms = {"beside": LLM(tdir, **engine), "rank": LLM(tdir, num_devices=2, **engine)}
        warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
        sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
        for llm in llms.values():
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
        tokens = {}
        for name, prompts in (("b8", prompts8), ("b1", prompt1)):
            runs = {"beside": [], "rank": []}
            for i, form in enumerate(DRAFT_RANK_TURNS):
                llm = llms[form]
                llm.draft_server.drain()
                n0 = len(getattr(llm.draft_server, "exchange_s", []))
                replays0 = _replays(llm)
                torch.cuda.synchronize()
                outs, m = llm.generate(prompts, sp, use_tqdm=False)
                counts = llm.draft_server.drain() if form == "rank" else None
                steps = max(1, len(m["target_step_times"]) - 1)
                run = dict(decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
                           graph_replays_per_decode_step=(_replays(llm) - replays0) / steps,
                           mean_accepted_suffix_len=sum(m["accepted_suffix_lens_with_recovery"])
                           / len(m["accepted_suffix_lens_with_recovery"]),
                           cache_hit_rate=sum(m["cache_hits"]) / len(m["cache_hits"]))
                if form == "rank":
                    ex = llm.draft_server.exchange_s[n0:]
                    run.update(exchange_ms_per_step=1e3 * sum(ex) / len(ex),
                               draft_rank_launches=counts)
                runs[form].append(run)
                toks = [o["token_ids"] for o in outs]
                if i >= 2 and toks != tokens.setdefault(name, toks):
                    fail(f"spec_draft_rank {name}: greedy tokens differ between the forms")
            out["runs"][name] = {form: dict(
                decode_tok_s=_spread([r["decode_tok_s"] for r in rs]),
                mean_accepted_suffix_len=[r["mean_accepted_suffix_len"] for r in rs],
                cache_hit_rate=[r["cache_hit_rate"] for r in rs],
                **({"exchange_ms_per_step": [r["exchange_ms_per_step"] for r in rs],
                    "draft_rank_launches": rs[0]["draft_rank_launches"]} if form == "rank" else {}),
                graph_replays_per_decode_step=rs[0]["graph_replays_per_decode_step"])
                for form, rs in runs.items()}
            emit("spec_draft_rank", batch=name, turns=DRAFT_RANK_TURNS, **out["runs"][name])
        for llm in llms.values():
            llm.exit()
    return out


def _tp_two_cards_nccl(cases, tp1) -> dict:
    """With two cards or more: the engine spawns its second rank on cuda:1
    (NCCL, graphs); the fp32 cases' greedy tokens equal tp 1's."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    out = {}
    for key, path, V, kw in cases:
        llm = LLM(path, num_devices=2, **{k: v for k, v in kw.items()
                                          if k != "num_kvcache_blocks"})
        run = _tp_serve(llm, _tp_prompts(V), TP_NEW)
        llm.exit()
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = dict(tokens_equal=run["tokens"] == tp1[key]["tokens"],
                        graph_replays=run["graph_replays"], collectives=run["collectives"])
        emit("tp", part="nccl_tp2_two_cards", case=key, **out[key])
        if kw["dtype"] == "float32" and not out[key]["tokens_equal"]:
            fail(f"tp: {key}: NCCL tp 2 tokens differ from tp 1")
    return out


# ---------------------------------------------------------------------------
# Phases eagle_tp and eagle_tp_cards
# ---------------------------------------------------------------------------


def _eagle_tp_kw(ddir: str, form: str, **over) -> dict:
    """An EAGLE-3 engine of the eagle_tp phases: the fused sync superstep
    ("fused": SPEC_R rounds) or async ("async": the head on a draft rank
    of its own once num_devices > 1), K=SPEC_K, random weights from a
    seed."""
    form_kw = (dict(spec_rounds=SPEC_R) if form == "fused" else
               dict(draft_async=True, jit_speculate=True, async_fan_out=SPEC_F))
    return dict(init_random=True, kvcache_block_size=BLOCK, draft=ddir, speculate=True,
                use_eagle=True, speculate_k=SPEC_K, **form_kw, **over)


def _eagle_tp_serve(llm) -> dict:
    """_tp_serve of the eagle_tp prompts (TP_LENS, TP_NEW tokens each); with
    the head on a draft rank, _draft_rank_serve (the draft rank's launches
    and the exchange's ms a step)."""
    if llm.config.draft_ranks:
        return _draft_rank_serve(llm)
    return _tp_serve(llm, _tp_prompts(LLAMA_8B["vocab_size"]), TP_NEW)


def _eagle_tp_proc(rank: int, size: int, store: str, tdir: str, kw: dict, out_path: str):
    """One process of the eagle_tp phase's gloo group on the card (cuda:0,
    shared): every process builds the same engine over the group, eagerly;
    a draft rank's call serves the head until the target's exit. Each
    target rank writes what it served to out_path + rank."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size)
    try:
        from ssd_tpu_torch import LLM

        t0 = time.perf_counter()
        llm = LLM(tdir, num_devices=size, device="cuda", enforce_eager=True, **kw)
        if llm.draft_rank_launches is not None:
            return
        run = dict(_eagle_tp_serve(llm), init_s=time.perf_counter() - t0,
                   tp_size=llm.config.tp_size, draft_ranks=llm.config.draft_ranks,
                   head_heads=[llm.draft_runner.arch.num_heads, llm.draft_runner.arch.num_kv_heads]
                   if llm.draft_runner is not None else None)
        llm.exit()
        with open(f"{out_path}{rank}", "w") as f:
            json.dump(run, f)
    finally:
        dist.destroy_process_group()


def _spawn_group(target, size: int, args: tuple, timeout: int) -> list:
    """Start `size` processes target(rank, size, *args) (spawn), wait for
    them and return their exit codes; any still alive at the timeout is
    killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, size) + args) for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return codes


# Which kernels each rank of an eagle_tp form must launch: K1 (the target's
# and the head's prefill) and K2 (verify, the head's chain; async: glue
# too) everywhere; K3 (the tree) only where the async head runs.
EAGLE_TP_NEED = {"target": ("flat_prefill_attention", "paged_attention"),
                 "async_head": ("flat_prefill_attention", "paged_attention", "tree_attention")}


def phase_eagle_tp() -> dict:
    """EAGLE-3 under tensor parallelism on one card over gloo (module
    docstring, phase eagle_tp)."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = os.path.join(d, "target"), os.path.join(d, "head")
        os.makedirs(tdir)
        os.makedirs(ddir)
        _write_config(tdir, LLAMA_8B, num_hidden_layers=EAGLE_PAIR_LAYERS)
        _eagle_config(ddir)
        base = dict(dtype="float32", max_model_len=1024, max_num_seqs=len(TP_LENS),
                    num_kvcache_blocks=160)
        for form, size in (("fused", TP_RANKS), ("async", TP_RANKS + 1)):
            kw = _eagle_tp_kw(ddir, form, **base)
            llm = LLM(tdir, enforce_eager=True, **kw)
            one = _eagle_tp_serve(llm)
            llm.exit()
            del llm
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            result = os.path.join(d, f"{form}.json")
            codes = _spawn_group(_eagle_tp_proc, size, (os.path.join(d, f"store_{form}"), tdir,
                                                        kw, result), timeout=300)
            if codes != [0] * size:
                fail(f"eagle_tp: the {form} engine's gloo processes exited with {codes}")
            ranks = []
            for r in range(TP_RANKS):
                with open(f"{result}{r}") as f:
                    ranks.append(json.load(f))
            run = dict(
                tokens_equal=all(x["tokens"] == one["tokens"] for x in ranks),
                tp_size=ranks[0]["tp_size"], draft_ranks=ranks[0]["draft_ranks"],
                head_heads_rank0=ranks[0]["head_heads"],
                launches_by_rank={str(r): x["launches"] for r, x in enumerate(ranks)},
                collectives_rank0=ranks[0]["collectives"],
                launches_tp1=one["launches"], seconds_tp1=one["seconds"],
                seconds=ranks[0]["seconds"], init_s=ranks[0]["init_s"],
                processes_s=time.perf_counter() - t0,
                ms_per_decode_step=1e3 * ranks[0]["seconds"] / ranks[0]["decode_steps"],
                ms_per_decode_step_tp1=1e3 * one["seconds"] / one["decode_steps"])
            if form == "async":
                run.update(draft_rank_launches=ranks[0]["draft_rank_launches"],
                           exchange_ms_per_step=ranks[0]["exchange_ms_per_step"])
            out["runs"][form] = run
            emit("eagle_tp", form=form, geometry=f"Llama-3.1-8B cut to {EAGLE_PAIR_LAYERS} "
                 "layers + EAGLE-3 head (1 layer, draft vocab 32000), random fp32 weights",
                 processes=size, **run)
            if not run["tokens_equal"]:
                fail(f"eagle_tp: {form}: fp32 greedy tokens at tp {TP_RANKS} differ from tp 1")
            missing = {r: [k for k in EAGLE_TP_NEED["target"] if not launches[k]]
                       for r, launches in run["launches_by_rank"].items()}
            if form == "async":
                missing["draft_rank"] = [k for k in EAGLE_TP_NEED["async_head"]
                                         if not run["draft_rank_launches"][k]]
            if any(missing.values()) or not run["collectives_rank0"]["all_reduce_sum"]:
                fail(f"eagle_tp: {form}: kernels of the path did not launch where they run: "
                     f"{missing}, collectives {run['collectives_rank0']}")
    return out


# Llama-3.1-70B (huggingface.co/meta-llama/Llama-3.1-70B, config.json: width
# 8192, 64/8 heads of 128, MLP 28672, vocabulary 128256, 80 layers) as both
# packages compute it (rope theta 5e5 unscaled), and its EAGLE-3 head
# (huggingface.co/yuhuili/EAGLE3-LLaMA3.3-Instruct-70B: one layer at the
# target's width and heads, fc from 3 x 8192). The head's 2048 positions and
# its 32000-token draft vocabulary are assumed from EAGLE3_8B: no config can
# be read here.
LLAMA_70B = {**LLAMA_8B, "hidden_size": 8192, "intermediate_size": 28672,
             "num_hidden_layers": 80, "num_attention_heads": 64, "num_key_value_heads": 8}
EAGLE3_70B = {**EAGLE3_8B, "hidden_size": 8192, "intermediate_size": 28672,
              "num_attention_heads": 64, "num_key_value_heads": 8}
EAGLE_TP_CARDS_NEW = 128            # tokens a sequence, b8 and b1


def _eagle_tp_cards_run(llm, prompts: list[list[int]], n_new: int = EAGLE_TP_CARDS_NEW,
                        keep_tokens: bool = False) -> dict:
    """One greedy generate of n_new tokens a prompt with rank 0's counts
    zeroed just before and read just after (the draft rank's since the last
    drain): decode tok/s, accepted length, hit rate, exchange ms a step,
    launches, collectives, replays, and with keep_tokens the tokens."""
    import torch

    from ssd_tpu_torch import SamplingParams

    ranks = llm.draft_server if llm.config.draft_ranks else None
    if ranks is not None:
        ranks.drain()
        n0 = len(ranks.exchange_s)
    _tp_zero_counts()
    replays0 = _replays(llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, m = llm.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=n_new,
                                                   ignore_eos=True), use_tqdm=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for o in outs:
        if len(o["token_ids"]) != n_new:
            fail(f"eagle_tp_cards: bad output of {len(o['token_ids'])} tokens")
    lens = m["accepted_suffix_lens_with_recovery"]
    steps = max(1, len(m["target_step_times"]) - 1)
    run = dict(prompts=len(prompts), wall_s=wall, ttft_s=m["target_step_times"][0],
               decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
               decode_steps=steps,
               graph_replays_per_decode_step=(_replays(llm) - replays0) / steps,
               launches={w.__name__: w.launches for w in _kernel_wrappers()},
               collectives=_tp_comm_counts())
    if lens:
        run["mean_accepted_suffix_len"] = sum(lens) / len(lens)
    if m["cache_hits"]:
        run["cache_hit_rate"] = sum(m["cache_hits"]) / len(m["cache_hits"])
    if m["sd_superstep_times"]:
        t = m["sd_superstep_times"]
        run["superstep_ms"] = 1e3 * sum(t) / len(t)
    if ranks is not None:
        run["draft_rank_launches"] = ranks.drain()
        ex = ranks.exchange_s[n0:]
        run["exchange_ms_per_step"] = 1e3 * sum(ex) / len(ex)
    if keep_tokens:
        run["tokens"] = [o["token_ids"] for o in outs]
    return run


def phase_eagle_tp_cards() -> dict | None:
    """EAGLE-3 under tensor parallelism at Llama-3.1-70B's geometry over
    four cards (module docstring, phase eagle_tp_cards)."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    n = torch.cuda.device_count()
    if n < 4:
        emit("eagle_tp_cards", skipped=f"{n} card(s) visible; this phase needs 4")
        return None
    out = {"kernels": {}, "runs": {}}
    prompts8, prompt1 = _serving_prompts()
    prompts8 = _eagle_prompts(prompts8, EAGLE_TP_CARDS_NEW)
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = os.path.join(d, "target"), os.path.join(d, "head")
        os.makedirs(tdir)
        os.makedirs(ddir)
        _write_config(tdir, LLAMA_70B)
        _eagle_config(ddir, **{k: EAGLE3_70B[k] for k in (
            "hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads")})
        for form, devices, over in (("async", 3, {"quantization": "int8"}),
                                    ("fused", 4, {})):
            t0 = time.perf_counter()
            llm = LLM(tdir, num_devices=devices, dtype="bfloat16", max_model_len=EAGLE_MAX_LEN,
                      max_num_seqs=8, **_eagle_tp_kw(ddir, form, **over))
            init_s = time.perf_counter() - t0
            if llm.graphs is None or llm.comm.backend != "nccl":
                fail(f"eagle_tp_cards: the {form} engine runs no graphs or no NCCL")
            # A short warm-up generate on a prompt of its own (no prefix
            # shared with the measured ones), not reported.
            _eagle_tp_cards_run(llm, _tp_prompts(LLAMA_70B["vocab_size"])[:1], n_new=8)
            res = dict(init_s=init_s, tp_size=llm.config.tp_size,
                       draft_ranks=llm.config.draft_ranks, graphs=_graph_facts(llm),
                       b8=_eagle_tp_cards_run(llm, prompts8),
                       b1=_eagle_tp_cards_run(llm, prompt1))
            out["runs"][form] = res
            emit("eagle_tp_cards", form=form, num_devices=devices,
                 geometry="Llama-3.1-70B (80 layers) + EAGLE-3 head (1 layer, draft vocab "
                          "32000 and 2048 positions assumed), random weights, bf16"
                          + (", int8 weights" if over else ""), **res)
            t0 = time.perf_counter()
            llm.exit()
            emit("eagle_tp_cards", form=form, exit_s=time.perf_counter() - t0)
            del llm
            gc.collect()
            torch.cuda.empty_cache()
            need = ("flat_prefill_attention", "paged_attention")
            for b in ("b8", "b1"):
                r = res[b]
                if not all(r["launches"][k] for k in need) or not r["collectives"]["all_reduce_sum"] \
                        or not r["graph_replays_per_decode_step"] \
                        or (form == "async" and not r["draft_rank_launches"]["tree_attention"]):
                    fail(f"eagle_tp_cards: {form} {b}: a kernel, collective or graph of the path "
                         f"did not run: {r['launches']}, {r['collectives']}, "
                         f"{r.get('draft_rank_launches')}")
    for label, heads in (("tp4_rank", L70B_TP_HEADS["tp4"]),
                         ("async_head_whole", (64, 8, 128))):
        out["kernels"][label] = _attention_times(heads, f"Llama-3.1-70B {label}")
        for name, tm in out["kernels"][label].items():
            emit("eagle_tp_cards", kernel=name, heads=list(heads), **{label: tm})
    return out


# ---------------------------------------------------------------------------


# The head_dims phase's engines at full width and depth: (mode, kv_quant,
# batches), every one under graphs.
HD_PLAN = (("ar", None, ("b8", "b1")), ("sd", None, ("b8",)), ("ssd", None, ("b8",)),
           ("ar", "int8", ("b8",)), ("ssd", "int8", ("b8",)),
           ("ar", "int8_mxu", ("b8",)), ("ssd", "int8_mxu", ("b8",)))
HD_NEED = {None: {"ar": ("flat_prefill_attention", "paged_attention"),
                  "sd": ("flat_prefill_attention", "paged_attention"),
                  "ssd": ("flat_prefill_attention", "paged_attention", "tree_attention")},
           "int8": {"ar": ("flat_prefill_attention_int8", "paged_attention_int8"),
                    "ssd": ("flat_prefill_attention_int8", "paged_attention_int8",
                            "tree_attention_int8")}}


def _head_dims_exact(d: str) -> dict:
    """fp32 at OpenLLaMA-3B's width cut to 3 layers (2 live) with a noisy
    2-layer draft: AR, sync SD and async SSD under graphs over the fp32
    cache, and AR and SSD over the int8 cache, each equal to the card's
    eager AR of the same cache."""
    import numpy as np
    import torch

    from ssd_tpu_torch import LLM, SamplingParams

    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, OPEN_LLAMA_3B["vocab_size"], size=n).tolist()
               for n in (20, 77, 130)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True)
    engine = dict(dtype="float32", max_model_len=512, kvcache_block_size=BLOCK,
                  max_num_seqs=4, num_kvcache_blocks=32)
    os.makedirs(d)
    tdir, ddir = _spec_pair(d, layers=3, live=2, scale=0.4, dtype=torch.float32, seed=3,
                            base=OPEN_LLAMA_3B)
    tokens, seconds, accepted = {}, {}, {}
    for kvq, modes in ((None, ("ar_eager", "ar", "sd", "ssd")), ("int8", ("ar_eager", "ssd"))):
        for mode in modes:
            t0 = time.perf_counter()
            if mode.startswith("ar"):
                llm = LLM(tdir, kv_quant=kvq, enforce_eager=mode == "ar_eager", **engine)
            else:
                llm = _spec_llm(tdir, ddir, mode, kv_quant=kvq, **engine)
                _perturb_draft(llm, 0.01, 0.4)
            outs, m = llm.generate(prompts, sp, use_tqdm=False)
            llm.exit()
            if mode != "ar_eager" and llm.graphs is None:
                fail(f"head_dims exact: the {kvq or 'fp32'} {mode} engine holds no graphs")
            run = f"{kvq or 'fp32'}_{mode}"
            tokens[run] = [o["token_ids"] for o in outs]
            seconds[run] = time.perf_counter() - t0
            lens = m["accepted_suffix_lens_with_recovery"]
            accepted[run] = sum(lens) / len(lens) if lens else None
            del llm
    equal = {run: toks == tokens[run.rsplit("_", 1)[0] + "_ar_eager"]
             for run, toks in tokens.items() if not run.endswith("ar_eager")}
    out = dict(geometry="OpenLLaMA-3B width, 3 layers (2 live), fp32, init scale 0.4; "
               "2-layer draft, noise 0.01", equal=equal, accepted=accepted, seconds=seconds)
    emit("head_dims", exact=out)
    if not all(equal.values()):
        fail(f"head_dims exact: runs whose fp32 tokens differ from the card's eager AR: "
             f"{[r for r, ok in equal.items() if not ok]}")
    return out


def phase_head_dims() -> dict:
    """OpenLLaMA-3B at hd 100 through AR, SD and SSD (module docstring,
    phase head_dims)."""
    import torch

    from ssd_tpu_torch import LLM, SamplingParams

    V = OPEN_LLAMA_3B["vocab_size"]
    prompts8, prompt1 = _serving_prompts(V)
    warm = SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True)
    engine = dict(dtype="bfloat16", max_model_len=OPEN_LLAMA_3B["max_position_embeddings"],
                  kvcache_block_size=BLOCK, max_num_seqs=8)
    out = {"runs": {}, "init_s": {}}
    tokens = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tdir, ddir = _spec_pair(d, layers=OPEN_LLAMA_3B["num_hidden_layers"], live=SPEC_LIVE,
                                scale=0.02, dtype=torch.bfloat16, seed=5, base=OPEN_LLAMA_3B)
        out["checkpoint_s"] = time.perf_counter() - t0
        for mode, kvq, batches in HD_PLAN:
            t0 = time.perf_counter()
            llm = (LLM(tdir, kv_quant=kvq, **engine) if mode == "ar"
                   else _spec_llm(tdir, ddir, mode, kv_quant=kvq, **engine))
            torch.cuda.synchronize()
            label = f"{kvq or 'bf16'}_{mode}"
            out["init_s"][label] = time.perf_counter() - t0
            arch = llm.model_runner.arch
            if (arch.head_dim, arch.num_heads, arch.num_kv_heads) != (100, 32, 32) or llm.graphs is None:
                fail(f"head_dims {label}: hd {arch.head_dim}, heads {arch.num_heads}/"
                     f"{arch.num_kv_heads}, graphs {llm.graphs is not None}")
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
            for b in batches:
                run, toks = _spec_run(llm, mode, prompts8 if b == "b8" else prompt1, HD_NEW, V)
                key = f"{label}_{b}"
                tokens[key] = toks
                out["runs"][key] = run
                emit("head_dims", run=key, kv_quant=kvq, **run)
                if not run["graph_replays_per_decode_step"] > 0:
                    fail(f"head_dims {key}: no graph replayed")
                need = HD_NEED[kvq and "int8"][mode]
                other = [k for k, n in run["launches"].items()
                         if n and k.endswith("_int8") != bool(kvq) and "attention" in k]
                missing = [k for k in need if run["launches"][k] <= 0]
                if missing or other:
                    fail(f"head_dims {key}: kernels of the path that never launched {missing}, "
                         f"of the other cache that did {other}: {run['launches']}")
            llm.exit()
            del llm
            torch.cuda.empty_cache()
        out["exact"] = _head_dims_exact(os.path.join(d, "exact"))
    # At hd 100 int8_mxu runs int8's kernels (JAX's router takes no s8
    # kernel there), so its tokens are int8's bit for bit.
    for mode in ("ar", "ssd"):
        if tokens[f"int8_mxu_{mode}_b8"] != tokens[f"int8_{mode}_b8"]:
            fail(f"head_dims: int8_mxu {mode} tokens differ from int8's at hd 100")
    agree = {key: sum(a == b for x, y in zip(toks, tokens["bf16_ar_b8"]) for a, b in zip(x, y))
             / sum(map(len, toks)) for key, toks in tokens.items()
             if key.endswith("_b8") and key.startswith("bf16_") and key != "bf16_ar_b8"}
    out["bf16_agreement_with_ar"] = agree
    launched = {}
    for run in out["runs"].values():
        for k, n in run["launches"].items():
            launched[k] = launched.get(k, 0) + n
    kernels = [w.__name__ for w in _kernel_wrappers()[:6]]
    if not all(launched[k] > 0 for k in kernels):
        fail(f"head_dims: a kernel of K1-K5 never launched at hd 100: {launched}")
    emit("head_dims", geometry="OpenLLaMA-3B (26 layers, width 3200, 32/32 heads of 100, "
         "random bf16 weights; SD/SSD: layers >= 4 pass-through, the first 4 as the draft)",
         prompts=[len(p) for p in prompts8], new_tokens=HD_NEW, init_s=out["init_s"],
         checkpoint_s=out["checkpoint_s"], bf16_agreement_with_ar=agree, launches=launched,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


# ---------------------------------------------------------------------------
# Phase 17
# ---------------------------------------------------------------------------


class _TokenIds:
    """The chat turn's stand-in tokenizer (tests/test_cli_surfaces.py's):
    token ids as text, a chat history as a short deterministic prompt."""
    eos_token_id = 2

    def apply_chat_template(self, history, add_generation_prompt=True):
        seed = sum(len(m["content"]) for m in history) % 40
        return [1, 3 + seed, 5, 7]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def encode(self, text):
        return [1, 5, 9]


def _echoed(fn, *args, **kw):
    """fn's result and what it printed, which is printed here too."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue()


def phase_cli() -> dict:
    """The port's CLIs through their main(argv) on the card (module
    docstring, phase 17)."""
    import builtins
    import re

    import numpy as np
    import torch

    from ssd_tpu_torch.bench import bench as bench_cli
    from ssd_tpu_torch.bench import chat as chat_cli
    from ssd_tpu_torch.bench import compare_outputs
    from ssd_tpu_torch.engine import llm_engine

    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    out = {"seconds": {}}
    with tempfile.TemporaryDirectory() as d:
        # compare_outputs on exact's fp32 pair (3 layers, 2 live; the draft
        # noisy, so SD and SSD both accept and reject), a token-id prompt.
        t0 = time.perf_counter()
        os.makedirs(os.path.join(d, "fp32"))
        tdir, ddir = _spec_pair(os.path.join(d, "fp32"), layers=3, live=2, scale=0.4,
                                dtype=torch.float32, seed=3, draft_noise=0.01)
        ids = np.random.default_rng(5).integers(3, LLAMA_1B["vocab_size"], size=40).tolist()
        rc, text = _echoed(compare_outputs.main, [
            "--model-path", tdir, "--draft", ddir, "--prompt-ids", *map(str, ids),
            "--max_new_tokens", "48", "--k", str(SPEC_K), "--f", str(SPEC_F),
            "--max_model_len", "512", "--block_sz", str(BLOCK)], dtype="float32")
        matches = text.count("EXACT MATCH")
        out["compare_outputs"] = {"rc": rc, "exact_matches": matches, "prompt_tokens": len(ids),
                                  "new_tokens": 48}
        out["seconds"]["compare_outputs"] = time.perf_counter() - t0
        if rc != 0 or matches != 3:
            fail(f"cli: compare_outputs returned {rc} with {matches} EXACT MATCH lines of 3")

        # bench at the full Llama-3.2-1B depth in bf16: AR b8, then async
        # SSD b8 with spec's 4-layer draft; 8 random-id prompts of 128.
        t0 = time.perf_counter()
        os.makedirs(os.path.join(d, "bf16"))
        tdir, ddir = _spec_pair(os.path.join(d, "bf16"), layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        out["seconds"]["checkpoints"] = time.perf_counter() - t0
        common = ["--model-path", tdir, "--random", "--b", "8", "--numseqs", "8",
                  "--input_len", "128", "--output_len", "64", "--block_sz", str(BLOCK),
                  "--max_model_len", "512", "--warm-passes", "1"]
        for mode, extra in (("ar", []), ("ssd", ["--draft", ddir, "--spec", "--async",
                                                 "--k", str(SPEC_K), "--f", str(SPEC_F)])):
            t0 = time.perf_counter()
            _, text = _echoed(bench_cli.main, common + extra)
            m = re.search(r"Total: (\d+) tokens in ([\d.]+)s = ([\d.]+) tok/s end-to-end", text)
            if m is None or int(m.group(1)) != 8 * 64:
                fail(f"cli: bench {mode} printed no total of {8 * 64} tokens")
            # The measured pass's decode rate (the warm-up pass prints first).
            decode = re.findall(r"Final Decode Throughput: (\d+)tok/s", text)
            out[f"bench_{mode}_b8"] = {
                "tokens": int(m.group(1)), "seconds": float(m.group(2)),
                "end_to_end_tok_s": float(m.group(3)),
                "decode_tok_s": int(decode[-1]) if decode else None}
            out["seconds"][f"bench_{mode}"] = time.perf_counter() - t0

        # One scripted chat turn in engine mode with the stand-in tokenizer.
        t0 = time.perf_counter()
        turns = iter(["hello there"])

        def scripted(prompt=""):
            try:
                return next(turns)
            except StopIteration:
                raise EOFError from None

        real_input, real_tok = builtins.input, llm_engine.load_tokenizer
        builtins.input, llm_engine.load_tokenizer = scripted, lambda path: _TokenIds()
        try:
            _, text = _echoed(chat_cli.main, ["--model-path", tdir, "--max_new_tokens", "32",
                                              "--max_model_len", "512", "--block_sz", str(BLOCK)])
        finally:
            builtins.input, llm_engine.load_tokenizer = real_input, real_tok
        m = re.search(r"\[ttft ([\d.]+)s \| ([\d.]+) tok/s\]", text)
        streamed = text.split("Assistant: ")[-1].split("\n[ttft")[0]
        if m is None or not streamed.strip():
            fail("cli: the chat turn streamed no tokens or printed no TTFT")
        out["chat_turn"] = {"ttft_s": float(m.group(1)), "tok_s": float(m.group(2)),
                            "streamed_chars": len(streamed)}
        out["seconds"]["chat"] = time.perf_counter() - t0
    out["launches"] = {w.__name__: w.launches for w in wrappers if w.launches}
    emit("cli", geometry="compare_outputs: Llama-3.2-1B width, 3 layers (2 live), fp32; "
         "bench and chat: Llama-3.2-1B (16 layers, random bf16 weights; SSD's draft its "
         "first 4 layers)", **{k: v for k, v in out.items() if k != "seconds"},
         phase_seconds=out["seconds"])
    need = ("paged_attention", "flat_prefill_attention", "tree_attention")
    if not all(out["launches"].get(n, 0) > 0 for n in need):
        fail(f"cli: a kernel of the CLIs' paths never launched: {out['launches']}")
    return out


PALLAS = "ssd_tpu/ops/pallas_attention.py"
# name in the kernels line -> (source, the TPU kernel it replaces)
KERNEL_ROWS = {
    "paged_attention": ("ssd_tpu_torch/csrc/paged_attention.cu",
                        f"{PALLAS}:354 (_paged_attn_v2_kernel, B=1); :622 (_paged_attn_v3_kernel, B>1)"),
    "flat_prefill_attention": ("ssd_tpu_torch/csrc/flat_prefill_attention.cu",
                               f"{PALLAS}:1700 (_flat_prefill_kernel)"),
    "tree_attention": ("ssd_tpu_torch/csrc/tree_attention.cu",
                       f"{PALLAS}:1527 (_tree_attn_kernel); :1024 (_tree_attn_v2_kernel, B=1); "
                       ":1221 (_tree_attn_v3_kernel, B>1)"),
    "paged_attention_int8": ("ssd_tpu_torch/csrc/paged_attention_int8.cu",
                             f"{PALLAS}:632 (_paged_attn_v3_kernel_i8, s8=False: kv_quant int8)"),
    "paged_attention_int8[s8]": ("ssd_tpu_torch/csrc/paged_attention_int8.cu",
                                 f"{PALLAS}:632 (_paged_attn_v3_kernel_i8, s8=True: kv_quant int8_mxu)"),
    "flat_prefill_attention_int8": ("ssd_tpu_torch/csrc/flat_prefill_attention.cu",
                                    f"{PALLAS}:1700 (_flat_prefill_kernel) over the int8 pages that "
                                    "ssd_tpu/ops/attention.py:132 (dense_pages) dequantizes"),
    "tree_attention_int8": ("ssd_tpu_torch/csrc/tree_attention_int8.cu",
                            f"{PALLAS}:1231 (_tree_attn_v3_kernel_i8, s8=False: kv_quant int8)"),
    "tree_attention_int8[s8]": ("ssd_tpu_torch/csrc/tree_attention_int8.cu",
                                f"{PALLAS}:1231 (_tree_attn_v3_kernel_i8, s8=True: kv_quant int8_mxu)"),
    "grouped_gemm": ("ssd_tpu_torch/csrc/grouped_gemm.cu",
                     "ssd_tpu/models/transformer.py:268-273 (megablox gmm, called by _moe_mlp :164)"),
    "s8_dot_mma": ("ssd_tpu_torch/csrc/s8_probe.cu",
                   "bench/s8_probe.py:18 (_kernel_s8, pallas_call :36)"),
    "s8_dot_dp4a": ("ssd_tpu_torch/csrc/s8_probe.cu",
                    "bench/s8_probe.py:18 (_kernel_s8, pallas_call :36), on SIMT"),
    "s8_dot_bf16": ("ssd_tpu_torch/csrc/s8_probe.cu",
                    "bench/s8_probe.py:25 (_kernel_bf16, pallas_call :36)"),
    "paged_attention_diag": ("ssd_tpu_torch/csrc/paged_attention.cu (stage variants)",
                             "bench/kernel_diag.py:39 (_diag_kernel, pallas_call :171)"),
    "paged_attention_int8_diag": ("ssd_tpu_torch/csrc/paged_attention_int8.cu (stage variants)",
                                  "bench/kernel_diag.py:39 (_diag_kernel, pallas_call :171) "
                                  "over the int8 cache"),
    "int8_linear": ("ssd_tpu_torch/csrc/int8_weight_gemm.cu",
                    "none: XLA's convert fused into the dot under quantization='int8' "
                    "(ssd_tpu/models/transformer.py:153-161 _mm, :224-233, :265-278, :290-293, "
                    ":415-417; ssd_tpu/models/eagle3.py:93-104, :175-177)"),
}


# ---------------------------------------------------------------------------
# Phases hosts and hosts_cards
# ---------------------------------------------------------------------------

HOSTS = 2                           # the hosts phases' "hosts"
HOSTS_NEW = 32                      # tokens a sequence in the hosts phase (a)
HOSTS_FULL_NEW = 16                 # and in each of its full-depth turns (b)
HOSTS_CARDS_NEW = 128               # and in hosts_cards


def _free_ports(n: int) -> list[int]:
    """n TCP ports free on the loopback now."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _time_hosts_layers() -> dict:
    """Wrap the rendezvous (parallel/comm.py::_join) and the union of the
    draft replies (engine/speculator_async.py::union_parts) of this process
    so that each call's seconds (and the union's bytes) are recorded."""
    from ssd_tpu_torch.engine import speculator_async
    from ssd_tpu_torch.parallel import comm

    rec = {"join_s": [], "union": []}
    join, union = comm._join, speculator_async.union_parts

    def timed_join(*a, **kw):
        t0 = time.perf_counter()
        out = join(*a, **kw)
        rec["join_s"].append(time.perf_counter() - t0)
        return out

    def timed_union(parts, B, K, V, c):
        # The union ends in a host read, which waits for the target's stream
        # and so for the draft's reply logits it waited on: that wait is
        # timed apart, before the union.
        import torch

        t0 = time.perf_counter()
        if c.device.type == "cuda":
            torch.cuda.current_stream(c.device).synchronize()
        t1 = time.perf_counter()
        out = union(parts, B, K, V, c)
        rec["union"].append((time.perf_counter() - t1, t1 - t0,
                             B * (K + 1) * 4 + B * K * V * 4))
        return out

    comm._join, speculator_async.union_parts = timed_join, timed_union
    return rec


def _union_facts(rec: dict, n0: int = 0) -> dict:
    """The union's calls since the n0-th: ms a call, the wait for the
    draft's reply on the card before it, and bytes a call."""
    u = rec["union"][n0:]
    if not u:
        return {}
    return dict(union_calls=len(u), union_ms_per_step=1e3 * sum(t for t, _, _ in u) / len(u),
                reply_wait_ms_per_step=1e3 * sum(w for _, w, _ in u) / len(u),
                union_bytes_per_step=sum(b for _, _, b in u) / len(u))


def _hosts_proc(host: int, hosts: int, ports: list, cases: list, store: str, out_path: str):
    """One "host" of the hosts phase on the card (cuda:0, shared with the
    other host, so the rendezvous picks gloo): each case's engine, eagerly,
    either joins the hosts through the TCP rendezvous on 127.0.0.1 (layout
    "hosts", a fresh port each) or runs over a tp-2 group of the caller's
    over gloo (layout "gloo_tp2", the tp phase's layout: rank h on host h's
    process, a fresh FileStore each). Host h writes what it served to
    out_path + h."""
    import gc

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    from ssd_tpu_torch import LLM

    rec = _time_hosts_layers()
    results = {}
    for i, ((key, layout, path, prompts, n_new, kw), port) in enumerate(zip(cases, ports)):
        if layout == "gloo_tp2":
            dist.init_process_group("gloo", init_method=f"file://{store}_{i}", rank=host,
                                    world_size=hosts)
            kw = dict(kw, num_devices=hosts)
        else:
            kw = dict(kw, num_hosts=hosts, num_devices=hosts, host_id=host,
                      coordinator_address=f"127.0.0.1:{port}")
        try:
            t0 = time.perf_counter()
            llm = LLM(path, device="cuda", enforce_eager=True, **kw)
            init_s = time.perf_counter() - t0
            n0 = len(rec["union"])
            results[key] = dict(_tp_serve(llm, prompts, n_new), init_s=init_s,
                                backend=llm.comm.backend, ranks=llm.comm.size,
                                **_union_facts(rec, n0))
            if layout == "hosts":
                results[key]["join_s"] = rec["join_s"][-1]
            llm.exit()
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            if layout == "gloo_tp2":
                dist.destroy_process_group()
    with open(f"{out_path}{host}", "w") as f:
        json.dump(results, f)


def _agreement(a: list, b: list) -> dict:
    """Tokens equal, tokens agreeing, and each sequence's first differing
    step."""
    return dict(tokens_equal=a == b,
                tokens_agreeing=sum(x == y for ta, tb in zip(a, b) for x, y in zip(ta, tb)),
                tokens=sum(map(len, a)),
                first_differing_step=[next((i for i, (x, y) in enumerate(zip(ta, tb))
                                            if x != y), None) for ta, tb in zip(a, b)])


# Which kernels each hosts case must launch on every host: K1 and K2, and
# K3 where the async draft builds its trees.
HOSTS_NEED = ("flat_prefill_attention", "paged_attention")


# The hosts phase's full-depth bf16 runs, in turns: two hosts against the
# same ranks as a gloo tp-2 group of the caller's.
HOSTS_TURNS = ("hosts", "gloo_tp2", "gloo_tp2", "hosts")


def phase_hosts() -> dict:
    """Multi-host serving on one card (module docstring, phase hosts)."""
    import gc
    import multiprocessing as mp

    import torch

    from ssd_tpu_torch import LLM

    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as d:
        ldir, fdir = os.path.join(d, "llama_4l"), os.path.join(d, "llama_full")
        os.makedirs(ldir)
        os.makedirs(fdir)
        _write_config(ldir, num_hidden_layers=4)
        _write_config(fdir)
        base = dict(init_random=True, dtype="float32", max_model_len=1024,
                    kvcache_block_size=BLOCK, max_num_seqs=2, num_kvcache_blocks=160)
        spec = dict(draft=ldir, speculate=True, speculate_k=SPEC_K)
        prompts = _tp_prompts(LLAMA_1B["vocab_size"])
        cases = [(key, "hosts", ldir, prompts, HOSTS_NEW, dict(base, **kw)) for key, kw in (
            ("ar_cb", {}),
            (f"fused_sd{SPEC_R}", dict(spec, spec_rounds=SPEC_R)),
            ("ssd_dp2", dict(spec, draft_async=True, async_fan_out=SPEC_F, draft_dp=HOSTS)))]
        prompts8, _ = _serving_prompts()
        full_kw = dict(init_random=True, dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                       kvcache_block_size=BLOCK, max_num_seqs=8, num_kvcache_blocks=320)
        turns = [(f"full_{layout}_{i}", layout, fdir, prompts8, HOSTS_FULL_NEW, full_kw)
                 for i, layout in enumerate(HOSTS_TURNS)]
        result = os.path.join(d, "hosts.json")
        ports = _free_ports(len(cases) + len(turns))
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_hosts_proc, args=(
            h, HOSTS, ports, cases + turns, os.path.join(d, "store"), result))
            for h in range(HOSTS)]
        for p in procs:
            p.start()
        # Meanwhile the references: the card's tp-1 engine of each case.
        tp1 = {}
        for key, _, path, ps, n_new, kw in cases:
            llm = LLM(path, enforce_eager=True, **kw)
            tp1[key] = _tp_serve(llm, ps, n_new)
            llm.exit()
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        for p in procs:
            p.join(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if codes != [0] * HOSTS:
            fail(f"hosts: the host processes exited with {codes}")
        hosts = []
        for h in range(HOSTS):
            with open(f"{result}{h}") as f:
                hosts.append(json.load(f))
        out["processes_s"] = time.perf_counter() - t0
    for key, *_ in cases:
        want, h0 = tp1[key], hosts[0][key]
        run = dict(
            backend=h0["backend"], ranks=h0["ranks"],
            tokens_equal_tp1=all(h[key]["tokens"] == want["tokens"] for h in hosts),
            metrics_equal_tp1=all((h[key]["cache_hits"], h[key]["accepted"])
                                  == (want["cache_hits"], want["accepted"]) for h in hosts),
            launches_by_host={str(i): h[key]["launches"] for i, h in enumerate(hosts)},
            collectives_host0=h0["collectives"], decode_tok_s=h0["decode_tok_s"],
            decode_tok_s_tp1=want["decode_tok_s"], init_s=h0["init_s"], join_s=h0["join_s"],
            **{k: h0[k] for k in ("union_calls", "union_ms_per_step", "reply_wait_ms_per_step",
                                  "union_bytes_per_step") if k in h0})
        if want["accepted"]:
            run["mean_accepted"] = sum(want["accepted"]) / len(want["accepted"])
        if want["cache_hits"]:
            run["cache_hit_rate"] = sum(want["cache_hits"]) / len(want["cache_hits"])
        out["runs"][key] = run
        emit("hosts", case=key, geometry="Llama-3.2-1B width, 4 layers, random fp32 weights, "
             "the target its own draft", hosts=HOSTS, **run)
        if not (run["tokens_equal_tp1"] and run["metrics_equal_tp1"]):
            fail(f"hosts: {key}: two hosts' fp32 tokens or speculation metrics differ from "
                 "the card's tp-1 engine")
        need = HOSTS_NEED + (("tree_attention",) if key.startswith("ssd") else ())
        missing = {i: [k for k in need if not launches[k]]
                   for i, launches in run["launches_by_host"].items()}
        if any(missing.values()) or not h0["collectives"]["all_reduce_sum"] \
                or (key.startswith("ssd") and not h0["collectives"]["union_sum"]):
            fail(f"hosts: {key}: kernels or collectives of the path did not run: {missing}, "
                 f"{h0['collectives']}")
    runs = [hosts[0][key] for key, *_ in turns]
    first = runs[0]["tokens"]
    run = dict(_agreement(first, runs[1]["tokens"]),
               all_turns_and_hosts_equal=all(h[key]["tokens"] == first
                                             for h in hosts for key, *_ in turns),
               turns=list(HOSTS_TURNS),
               decode_tok_s=[r["decode_tok_s"] for r in runs],
               seconds=[r["seconds"] for r in runs], init_s=[r["init_s"] for r in runs],
               join_s=[r["join_s"] for r in runs if "join_s" in r],
               backend=runs[0]["backend"], launches_host0=runs[0]["launches"],
               collectives_host0=runs[0]["collectives"])
    mean = {lay: [r["decode_tok_s"] for r, l in zip(runs, HOSTS_TURNS) if l == lay]
            for lay in ("hosts", "gloo_tp2")}
    run["hosts_over_gloo_tp2"] = sum(mean["hosts"]) / sum(mean["gloo_tp2"])
    out["runs"]["llama1b_bf16_ar_b8"] = run
    emit("hosts", case="llama1b_bf16_ar_b8", geometry="Llama-3.2-1B (16 layers), random bf16 "
         "weights, b8", against="the same engine as a gloo tp-2 group of the caller's (the tp "
         "phase's layout), in turns", **run)
    if not run["all_turns_and_hosts_equal"]:
        fail("hosts: llama1b_bf16_ar_b8: two hosts' tokens differ from the gloo tp-2 group's "
             "or from each other")
    if not all(runs[0]["launches"][k] for k in HOSTS_NEED):
        fail(f"hosts: llama1b_bf16_ar_b8: K1 or K2 never launched: {runs[0]['launches']}")
    return out


def _hosts_cards_proc(host: int, hosts: int, ports: list, cards: str, cases: list,
                      out_path: str):
    """One host of hosts_cards: cards `cards` (CUDA_VISIBLE_DEVICES, set
    before CUDA starts), num_devices over all hosts, NCCL, under graphs;
    this process is global rank host * 2 and spawns its second rank. It
    serves every case on one engine a mode and writes what it served to
    out_path + host."""
    os.environ["CUDA_VISIBLE_DEVICES"] = cards
    import torch

    from ssd_tpu_torch import LLM

    rec = _time_hosts_layers()
    results = {}
    for (mode, path, kw, runs), port in zip(cases, ports):
        t0 = time.perf_counter()
        llm = LLM(path, num_hosts=hosts, coordinator_address=f"127.0.0.1:{port}",
                  host_id=host, **kw)
        res = dict(init_s=time.perf_counter() - t0, join_s=rec["join_s"][-1],
                   backend=llm.comm.backend, graphs=llm.graphs is not None)
        for label, prompts, n_new in runs:
            n0 = len(rec["union"])
            res[label] = dict(_eagle_tp_cards_run(llm, prompts, n_new, keep_tokens=True),
                              **_union_facts(rec, n0))
        llm.exit()
        results[mode] = res
        del llm
        torch.cuda.empty_cache()
    with open(f"{out_path}{host}", "w") as f:
        json.dump(results, f)


def phase_hosts_cards() -> dict | None:
    """Multi-host serving at Llama-3.1-70B's geometry over four cards as two
    hosts of two (module docstring, phase hosts_cards)."""
    import gc

    import torch

    from ssd_tpu_torch import LLM

    n = torch.cuda.device_count()
    if n < 4:
        emit("hosts_cards", skipped=f"{n} card(s) visible; this phase needs 4")
        return None
    out = {"runs": {}}
    prompts8, prompt1 = _serving_prompts()
    prompts8 = _eagle_prompts(prompts8, HOSTS_CARDS_NEW)
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = os.path.join(d, "target"), os.path.join(d, "draft")
        os.makedirs(tdir)
        os.makedirs(ddir)
        _write_config(tdir, LLAMA_70B)
        _write_config(ddir)
        base = dict(init_random=True, num_devices=4, dtype="bfloat16",
                    max_model_len=EAGLE_MAX_LEN, kvcache_block_size=BLOCK, max_num_seqs=8)
        warm = (_tp_prompts(LLAMA_70B["vocab_size"])[:1], 8)
        cases = [("ar", tdir, base, [("warm",) + warm, ("b8", prompts8, HOSTS_CARDS_NEW),
                                      ("b1", prompt1, HOSTS_CARDS_NEW)]),
                 ("ssd_dp2", tdir, dict(base, draft=ddir, speculate=True, speculate_k=SPEC_K,
                                        draft_async=True, async_fan_out=SPEC_F, draft_dp=HOSTS),
                  [("warm",) + warm, ("b8", prompts8, HOSTS_CARDS_NEW)])]
        # One host: the same engines over a FileStore group of the four
        # ranks this process spawns (num_hosts=2, no coordinator).
        one = {}
        rec = _time_hosts_layers()
        for mode, path, kw, runs in cases:
            t0 = time.perf_counter()
            llm = LLM(path, num_hosts=HOSTS, **kw)
            res = dict(init_s=time.perf_counter() - t0, backend=llm.comm.backend,
                       graphs=_graph_facts(llm))
            if llm.graphs is None or llm.comm.backend != "nccl":
                fail(f"hosts_cards: the one-host {mode} engine runs no graphs or no NCCL")
            for label, prompts, n_new in runs:
                n0 = len(rec["union"])
                res[label] = dict(_eagle_tp_cards_run(llm, prompts, n_new, keep_tokens=True),
                                  **_union_facts(rec, n0))
            t0 = time.perf_counter()
            llm.exit()
            res["exit_s"] = time.perf_counter() - t0
            one[mode] = res
            emit("hosts_cards", layout="1 host x 4 cards (FileStore group)", mode=mode,
                 **{k: v for k, v in res.items() if k not in ("warm", "b8", "b1")},
                 **{label: {k: v for k, v in res[label].items() if k != "tokens"}
                    for label in ("b8", "b1") if label in res})
            del llm
            gc.collect()
            torch.cuda.empty_cache()
        ports = _free_ports(len(cases))
        result = os.path.join(d, "hosts_cards.json")
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_hosts_cards_proc, args=(
            h, HOSTS, ports, f"{2 * h},{2 * h + 1}", cases, result)) for h in range(HOSTS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, 1500 - (time.perf_counter() - t0)))
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if codes != [0] * HOSTS:
            fail(f"hosts_cards: the host processes exited with {codes}")
        two = []
        for h in range(HOSTS):
            with open(f"{result}{h}") as f:
                two.append(json.load(f))
    for mode, _, _, runs in cases:
        for label, *_ in runs[1:]:
            a, b = one[mode][label], two[0][mode][label]
            run = dict(_agreement(a["tokens"], b["tokens"]),
                       hosts_equal=b["tokens"] == two[1][mode][label]["tokens"],
                       backend=two[0][mode]["backend"], join_s=two[0][mode]["join_s"],
                       init_s_one_host=one[mode]["init_s"], init_s_hosts=two[0][mode]["init_s"],
                       **{f"{k}_one_host": a.get(k) for k in (
                           "decode_tok_s", "graph_replays_per_decode_step",
                           "mean_accepted_suffix_len", "cache_hit_rate", "collectives")},
                       **{f"{k}_hosts": b.get(k) for k in (
                           "decode_tok_s", "graph_replays_per_decode_step",
                           "mean_accepted_suffix_len", "cache_hit_rate", "collectives",
                           "union_ms_per_step", "reply_wait_ms_per_step",
                           "union_bytes_per_step")},
                       launches_host0=b["launches"])
            steps = max(1, b["decode_steps"])
            run["collectives_per_decode_step_hosts"] = {
                k: v / steps for k, v in b["collectives"].items()}
            out["runs"][f"{mode}_{label}"] = run
            emit("hosts_cards", case=f"{mode}_{label}",
                 geometry="Llama-3.1-70B (80 layers), random bf16 weights; draft: the "
                          "Llama-3.2-1B geometry (16 layers)",
                 layout="2 hosts x 2 cards (TCP rendezvous) against 1 host x 4 cards "
                        "(FileStore group)", **run)
            if not (b["graph_replays_per_decode_step"] and all(
                    b["launches"][k] for k in HOSTS_NEED)):
                fail(f"hosts_cards: {mode} {label}: no graph replays or K1/K2 never launched")
            if mode == "ssd_dp2" and not (b["launches"]["tree_attention"]
                                          and b["collectives"]["union_sum"]):
                fail(f"hosts_cards: {mode} {label}: K3 or the union never ran")
    return out


# ---------------------------------------------------------------------------
# Phase diag
# ---------------------------------------------------------------------------

DIAG_RUNS = (("sd", "sd_diag", ["--rounds", "16"]),
             ("sd_eagle", "sd_diag", ["--rounds", "16", "--eagle"]),
             ("fasync_b1", "fasync_diag", ["--rounds", "8", "--batch", "1"]),
             ("fasync_b8", "fasync_diag", ["--rounds", "8", "--batch", "8"]),
             ("prefill", "prefill_diag", ["--t", "2048", "--r", "4"]))


def _diag_launch_faults(label: str, tool: str, out: dict) -> list[str]:
    """Where a run's launches a replay break the decomposition (module
    docstring, phase 20); a variant with no launches entry is a fault."""
    faults = []

    def need(variant, ok, what):
        got = out["launches"].get(variant)
        if got is None or not ok(got):
            faults.append(f"{label} {variant}: {what}, launched {got}")

    if tool == "prefill_diag":
        per = out["layers"] * out["r"]
        need("full", lambda n: n["K1"] == per and n["K2"] == 0,
             f"K1 once a layer a prefill ({per}) and no K2")
        for v in ("no_kernel", "no_attn", "matmul", "head"):
            need(v, lambda n: n["K1"] == 0 and n["K2"] == 0, "no K1 and no K2")
    elif tool == "sd_diag":
        for v in ("full", "draft", "verify"):
            need(v, lambda n: n["K2"] > 0 and n["K3"] == 0, "K2 and no K3")
    else:
        need("full", lambda n: n["K2"] > 0 and n["K3"] > 0, "K2 and K3")
        need("sync", lambda n: n["K2"] > 0, "K2")
        need("build", lambda n: n["K3"] > 0, "K3")
        need("fork", lambda n: not any(n.values()), "no attention kernel")
    return faults


def phase_diag(profile: bool = False) -> dict:
    """The step-decomposition tools on the card (module docstring, phase
    20); with `profile` (phase diag_profile, not run by default) each
    variant also replays once under torch.profiler (the tools' --profile)."""
    import importlib
    import math

    import torch

    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    runs, seconds, faults = {}, {}, []
    for label, tool, argv in DIAG_RUNS:
        t0 = time.perf_counter()
        out = importlib.import_module(f"ssd_tpu_torch.bench.{tool}").main(
            argv + ["--reps", "3"] + (["--profile"] if profile else []))
        gc.collect()
        torch.cuda.empty_cache()
        seconds[label] = time.perf_counter() - t0
        runs[label] = out
        if out["full_replay_equals_eager"] is not True:
            faults.append(f"{label}: the full variant's graph replay differs from its eager call")
        for v in out["launches"]:
            if not (math.isfinite(out[v]) and out[v] > 0):
                faults.append(f"{label} {v}: {out[v]} ms a round")
        faults += _diag_launch_faults(label, tool, out)
    launches = {w.__name__: w.launches for w in wrappers if w.launches}
    emit("diag_profile" if profile else "diag",
         geometry="Llama-3.2-1B width, random bf16 weights: target 16 layers, draft 4 (or "
         "an EAGLE-3 head at the target's width), K=4, F=2, block 64; prefill 2048 tokens",
         runs=runs, launches=launches, phase_seconds=seconds)
    if faults:
        fail("diag: " + "; ".join(faults))
    return {"runs": runs, "launches": launches}


def kernels_line(kern: dict, serve: dict | None, spec: dict | None,
                 kvq: dict | None, moe_run: dict | None, quant: dict | None,
                 eagle: dict | None, exact: dict | None, tp: dict | None = None,
                 eagle_tp: dict | None = None, eagle_tp_cards: dict | None = None,
                 head_dims: dict | None = None, cli: dict | None = None,
                 hosts: dict | None = None, hosts_cards: dict | None = None,
                 diag: dict | None = None) -> dict:
    """Launches per path, each read from runs whose counts were zeroed just
    before them: `serve` (AR, AR multi-step) and `spec` (SD, fused SD,
    ngram, SSD, the fused exchange and superstep) for the fp-cache
    kernels, from the graph runs (launches counted through replays; the
    eager runs beside them are left out),
    `kvq` for the int8 ones (its int8_mxu runs for the [s8] entries; the
    int8 prefill counts the runs of both modes), `moe` (Qwen3-30B-A3B AR)
    for K1, K2 and the grouped GEMM, `eagle` (Llama-3.1-8B AR, EAGLE SSD over
    the fp and the int8 cache, the fused EAGLE superstep, the constructed
    pair's runs in both forms; graph runs only), `exact`'s
    1-layer Qwen3-MoE SD and SSD card runs for the grouped GEMM, `quant`
    (int8 weights: AR b8/b1 graph runs, fused SD and SSD b8, Qwen3-30B-A3B
    AR) and `exact`'s int8-weight card runs for K9, the probes' bench
    entry points (path "probe") for rows #11 and #12, and `tp`: the
    one-rank NCCL engines' graph runs ("tp1_nccl_<mode>") and rank 0 of the
    gloo tp-2 runs on one card ("tp2_<case>", per-rank heads), `eagle_tp`:
    every target rank of the gloo EAGLE engines ("eagle_tp2_<form>_rank<r>")
    and the async head's draft rank ("eagle_tp2_async_draft_rank"), and
    `eagle_tp_cards` when it ran: rank 0 of the NCCL engines and the draft
    rank ("eagle_tp_cards_<form>_<batch>[_draft_rank]"), with the kernels'
    times at their per-rank heads ("at_eagle_tp_cards_<label>"), and
    `head_dims`: OpenLLaMA-3B's graph runs at hd 100
    ("open_llama_3b_<cache>_<mode>_<batch>"), with the kernels' times at
    its heads ("at_open_llama_3b_hd100"), `cli`: the port's CLIs
    (compare_outputs' four engines, bench's AR and SSD runs, the chat
    turn) under the path "cli", and `hosts`: host 0 of the two hosts on
    one card ("hosts_<case>"), and `hosts_cards` when it ran: host 0's
    first rank ("hosts_cards_<mode>_<batch>"), and `diag`: the
    decomposition tools' runs (captures, replays and the eager checks)
    under the path "diag"."""
    by_path = {}

    def add(name, path, n):
        paths = by_path.setdefault(name, {})
        paths[path] = paths.get(path, 0) + n

    if serve:
        for path, launches in serve["launches"].items():
            for name, n in launches.items():
                add(name, path, n)
    if spec:
        for key, run in spec["runs"].items():
            if key.endswith("_eager"):
                continue
            for name in ("paged_attention", "flat_prefill_attention", "tree_attention"):
                add(name, key.split("_b")[0], run["launches"][name])
    if kvq:
        for key, run in kvq["runs"].items():
            mxu, path = key.startswith("int8_mxu"), key.split("_")[-2]
            for name in ("paged_attention_int8", "flat_prefill_attention_int8",
                         "tree_attention_int8"):
                tag = "[s8]" if mxu and name != "flat_prefill_attention_int8" else ""
                add(name + tag, path, run["launches"][name])
    if moe_run:
        for name in ("paged_attention", "flat_prefill_attention", "grouped_gemm"):
            add(name, "moe_ar", moe_run["launches"][name])
    if eagle:
        for key, run in eagle["runs"].items():
            if key.endswith("_eager"):
                continue
            path = ("llama8b_ar" if key.startswith("ar_") else
                    "eagle_int8" if key.startswith("eagle_int8") else
                    "eagle_fused" if key.startswith("eagle_fused") else
                    "eagle_pair_fused" if key.startswith("pair_fused") else
                    "eagle_pair" if key.startswith("pair") else "eagle")
            for name, n in run["launches"].items():
                if n:
                    add(name, path, n)
    if quant:
        for path, launches in quant["launches"].items():
            for name, n in launches.items():
                if n:
                    add(name, path, n)
    if exact and "k9_launches" in exact:
        for path, n in exact["k9_launches"].items():
            add("int8_linear", f"exact_{path}", n)
    for name, n in kern.get("probes", {}).get("launches", {}).items():
        add(name, "probe", n)
    if exact and "moe_launches" in exact:
        for mode in ("sd", "ssd"):
            add("grouped_gemm", f"moe_{mode}_1layer", exact["moe_launches"][f"cuda_{mode}"]["grouped_gemm"])
    if tp:
        for mode, run in tp["nccl_world_size_1"].items():
            for name, n in run["launches"].items():
                if n:
                    add(name, f"tp1_nccl_{mode}", n)
        for case, run in tp["runs"].items():
            for name, n in run["launches_tp2_rank0"].items():
                if n:
                    add(name, f"tp2_{case}", n)
        run = tp["draft_rank"]["gloo_one_card"]
        for label, launches in (("draft_rank_target", run["launches"]),
                                ("draft_rank", run["draft_rank_launches"])):
            for name, n in launches.items():
                if n:
                    add(name, label, n)
    if eagle_tp:
        for form, run in eagle_tp["runs"].items():
            for r, launches in run["launches_by_rank"].items():
                for name, n in launches.items():
                    if n:
                        add(name, f"eagle_tp2_{form}_rank{r}", n)
            for name, n in run.get("draft_rank_launches", {}).items():
                if n:
                    add(name, f"eagle_tp2_{form}_draft_rank", n)
    if eagle_tp_cards:
        for form, res in eagle_tp_cards["runs"].items():
            for b in ("b8", "b1"):
                for label, launches in (("", res[b]["launches"]),
                                        ("_draft_rank", res[b].get("draft_rank_launches", {}))):
                    for name, n in launches.items():
                        if n:
                            add(name, f"eagle_tp_cards_{form}_{b}{label}", n)
    if head_dims:
        for key, run in head_dims["runs"].items():
            for name, n in run["launches"].items():
                if n:
                    add(name, f"open_llama_3b_{key}", n)
    for name, n in (cli or {}).get("launches", {}).items():
        add(name, "cli", n)
    for case, run in (hosts or {}).get("runs", {}).items():
        launches = run["launches_by_host"]["0"] if "launches_by_host" in run \
            else run["launches_host0"]
        for name, n in launches.items():
            if n:
                add(name, f"hosts_{case}", n)
    for case, run in (hosts_cards or {}).get("runs", {}).items():
        for name, n in run["launches_host0"].items():
            if n:
                add(name, f"hosts_cards_{case}", n)
    for name, n in (diag or {}).get("launches", {}).items():
        add(name, "diag", n)
    out = []
    for name, tm in kern["timings"].items():
        err = max(v["max_abs_err"] for (k, _, _), v in kern["errors"].items() if k == name)
        paths = by_path.get(name)
        source, replaces = KERNEL_ROWS[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()) if paths else None,
            "launches_by_path": paths or {},
            "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        }
        # The head widths held against the plain version (_head_dim_kernels'
        # cases "hd<width>_..."), each with its largest error.
        by_hd = {}
        for (k, case, _), v in kern["errors"].items():
            if k == name and case.startswith("hd") and case[2].isdigit():
                hd = int(case[2:].split("_")[0])
                by_hd[hd] = max(by_hd.get(hd, 0.0), v["max_abs_err"])
        if by_hd:
            entry["max_abs_err_by_head_dim"] = {str(h): by_hd[h] for h in sorted(by_hd)}
        # The paged kernels also run the SD/SSD verify and glue at Q = K+1,
        # and are timed at a long context.
        gmm = kern["grouped_gemm"]
        for label, table in (("at_verify_shape", kern["at_verify"]),
                             ("at_long_context", kern["long_context"]),
                             ("at_qwen3_moe_geometry", kern["qwen3_moe"]),
                             ("at_llama31_8b_eagle", kern["llama31_8b_eagle"]),
                             ("at_llama31_70b_tp4", kern["llama31_70b_tp4"]),
                             ("at_open_llama_3b_hd100", kern["open_llama_3b"]),
                             ("at_tree_b1", kern["tree_b1"]),
                             ("at_prefill_down", {"grouped_gemm": gmm["prefill_down"]}),
                             ("at_decode_b8_gate", {"grouped_gemm": gmm["decode_b8_gate"]}),
                             ("at_decode_b8_down", {"grouped_gemm": gmm["decode_b8_down"]}),
                             ("at_decode_b1_gate", {"grouped_gemm": gmm["decode_b1_gate"]}),
                             ("at_decode_b1_down", {"grouped_gemm": gmm["decode_b1_down"]})):
            if name in table:
                entry[label] = {k: table[name][k] for k in
                                ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                                + (("route",) if "route" in table[name] else ())}
        for label, table in (eagle_tp_cards or {}).get("kernels", {}).items():
            if name in table:
                entry[f"at_eagle_tp_cards_{label}"] = {k: table[name][k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "int8_linear":
            entry["at_shapes"] = {case: {k: t[k] for k in (
                "shape", "route", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library", "bf16_ms", "bf16")}
                for case, t in kern["int8_linear"].items() if "ms" in t}
            entry["shared_x"] = {case: t for case, t in kern["int8_linear"].items()
                                 if "shared_ms" in t}
        if "library" in tm:
            entry["library"] = tm["library"]
        long_s8 = f"at_l{LONG_S8_L}"
        if long_s8 in tm:
            entry[long_s8] = {k: tm[long_s8][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")}
        if "stages_ms" in tm:
            entry["stages_ms"] = tm["stages_ms"]
            entry[f"at_b8_x_{LONG_CTX}"] = {k: tm[f"at_b8_x_{LONG_CTX}"][k] for k in
                                            ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "stages_ms")}
        out.append(entry)
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES + EXTRA_PHASES):
        ap.error(f"unknown phases {set(phases) - set(PHASES + EXTRA_PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import ssd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Every CUDA graph capture runs a full collection (engine/graphs.py and
    # torch.cuda.graph); the imported modules' objects need none.
    gc.freeze()

    t0 = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        if name not in phases:
            return None
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    phase_env()   # always: the card's name and power limit
    kern = run("kernels", phase_kernels)
    serve = run("serve", phase_serve)
    spec = run("spec", phase_spec)
    kvq = run("kvq", phase_kvq, serve, spec)
    moe_run = run("moe", phase_moe)
    quant = run("quant", phase_quant, serve, spec, moe_run)
    eagle = run("eagle", phase_eagle)
    exact = run("exact", phase_exact)
    tp = run("tp", phase_tp)
    eagle_tp = run("eagle_tp", phase_eagle_tp)
    eagle_tp_cards = run("eagle_tp_cards", phase_eagle_tp_cards)
    head_dims = run("head_dims", phase_head_dims)
    cli = run("cli", phase_cli)
    hosts = run("hosts", phase_hosts)
    hosts_cards = run("hosts_cards", phase_hosts_cards)
    diag = run("diag", phase_diag)
    run("profile", phase_profile)
    run("moe_profile", phase_profile, True)
    run("quant_profile", phase_profile, False, "int8")
    run("quant_moe_profile", phase_profile, True, "int8")
    run("spec_profile", phase_spec_profile)
    run("spec_async", phase_spec_async)
    run("spec_draft_rank", phase_spec_draft_rank)
    run("eagle_profile", phase_eagle_profile)
    run("diag_profile", phase_diag, True)
    if kern is not None:
        print(json.dumps(kernels_line(kern, serve, spec, kvq, moe_run, quant, eagle, exact, tp,
                                      eagle_tp, eagle_tp_cards, head_dims, cli, hosts,
                                      hosts_cards, diag)), flush=True)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds, phases=phases)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
