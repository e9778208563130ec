#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SLING on one NVIDIA card.

    python3 chip_smoke.py                  # the paper's Enron regime
    python3 chip_smoke.py --graph GrQc     # a smaller Table-3 regime

Phases (any failure raises and the script exits non-zero):

  1. device: a CUDA card is required; prints its name and power limit;
  2. build the hand-written kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel);
  3. the port's main path at real size, through the entry points a user
     calls: ``build_index`` (Alg-4 walk diagonal + dense Alg-2 table on
     the card) at the paper's eps = 0.025, c = 0.6, then ``QueryEngine``
     ``warmup`` and pair, single-source and top-k (k = 10) batches. The
     kernels' launch counters are zeroed just before and read just
     after; both kernels must have launched, the dispatch shape set must
     not grow after warmup, and sampled answers must match an engine on
     the plain backends on the card;
  3b. the dynamic-graph path at real size: an index built with
     stale_frac = 0.2 behind a warm engine takes two random churn
     batches (0.1 % and 1 % of m) through ``update_index`` on the card,
     each hot-swapped in with ``swap_index`` and served; the repaired
     rows R are checked against a from-scratch rebuild of the mutated
     graph on every target in K. The counters are zeroed before and
     read after the batches; ``spmm`` must launch in both 3 and 3b;
  3c. xDeepFM serving at full width (``xdeepfm.full()``, 432,742,000
     parameters from a seeded ``torch.Generator``): serve_p99 (22
     ``RecsysStream`` batches of 512 through ``recsys_serve_step``, per
     batch p50/p99 from CUDA events), retrieval_cand (one user against
     1,000,000 candidates through ``recsys_retrieval_step``, top-128),
     then the SLING prior: a 40,000-node user-item click graph indexed
     on the card, ``single_source_device`` for 8 users and retrieval
     over its 30,000 items with ``sim_prior``. The counters are zeroed
     before and read after; ``cin``, ``horner_push`` and ``spmm`` must
     all launch. Checks (outside the counts): logits against the plain
     CIN on the card, top-128 against a stable sort, fused - base =
     sim_w * prior;
  3d. the index artifact at the Enron regime, in a temporary directory
     under ``build/`` that is removed after: phase 3's float32 index is
     saved as v3 (bytes and seconds printed), loaded eagerly onto the
     card and mapped (``mmap=True``), and served from the mapped file
     through ``QueryEngine.from_index_file`` (install ms); the sample
     must equal phase 3's answers bit for bit. A v2 ``.npz`` round
     trip follows. Then, with the counters zeroed: ``build_index(
     quant_frac=0.2)`` on the card, ``quantize_index(int16)``, a v3
     save, the mapped file served; ``hp_join``, ``horner_push`` and
     ``spmm`` must launch, and the answers must lie within
     ``quant_charge`` of the same plan's float32 index on the card, the
     float payload at most 0.6x, and ``quantize_index(bf16)`` must be
     refused at this plan. Last, ``build_index(space_reduce=True,
     enhance=True)``: rows reduced, bytes saved, a v3 round trip of the
     ``reduced`` and ``marks`` members, ``QueryEngine``'s refusal, and
     64 ``query_pair_host(u, v, g)`` answers beside the unreduced
     index's;
  3e. the scale path at 10^6 nodes (the reference's run_scale setting,
     ``benchmarks/bench_space.py:148``), in a temporary directory under
     ``build/``: ``powerlaw_fast(10^6, k=6, seed=0)``, then
     ``build_index_scale(eps=0.5, quant_frac=0.2, int16)`` on the card
     with ``builder="auto"`` (it must pick prsim, with the chunked
     certified diagonal) and again with ``builder="sling"`` (the two
     files must be equal byte for byte outside the header's builder);
     the prsim file loaded mapped and served by two
     ``from_index_file(mmap=True)`` engines: single-source and top-k
     batches of 2 and 8 (the graph's hub among the sources) and 64
     pairs. The counters are zeroed before the first build and read
     after the last batch; ``hp_join`` and ``horner_push`` must launch.
     Then, outside the counts, every answer against an engine on the
     plain backends on the card (BACKEND_ATOL); the build, load and
     install times, entries, width, bytes, the peak host RSS of the
     phase (statm sampled) and of the process, and the peak device
     memory are printed. Last, the
     build options on phase 3's graph: ``build_hp_table`` with
     ``spill_dir`` and a width 64 above the table's, equal to phase 3's
     table with the extra columns PAD; ``spmm`` must launch. With
     ``--profile``, four hub batches and four tail blocks of the sparse
     build are traced;
  3f. the bulk join (``repro_torch.join``): on phase 3's index, an
     all-sources ``run_join`` with ``JoinConfig(k=16, tile=64)`` (574
     tiles), a threshold sweep (tau the median 16th score, cap 256) over
     a seeded 4,096-source subset, and the top-k sweep again with a
     checkpoint, stopped after 100 tiles and resumed (equal bits to the
     uninterrupted sweep); the artifact saved, loaded and attached to
     phase 3's engine, served by ``knn(u)``, refused after a swap to a
     repaired copy (0.1 % churn) until a fresh join is attached. Then
     on phase 3e's mapped 10^6 index a seeded 4,096-source subset that
     holds the hub, stopped and resumed once (the full sweep, 15,625
     tiles, does not fit the time limit). The counters are zeroed
     before each part's sweeps and read after; ``horner_push`` must
     launch once per tile. Outside the counts, 256 sampled rows against
     ``QueryEngine.topk(u, 16)`` and against a plain-push sweep on the
     card (scores within BACKEND_ATOL, ids equal outside near-ties);
     per-tile p50/p99, sources a second, artifact and checkpoint bytes
     and ms, peak device memory;
  3g. the serving frontend: ``ServeFrontend.from_index_file(mmap=True)``
     on phase 3d's v3 file, two replicas on the card with worker
     threads, least-loaded routing, max_wait 2 ms, a 50 ms deadline;
     after ``warmup``, 6,000 Zipf(1.1) requests (pair, single-source and
     top-k in turn) as fast as admission takes them, a 0.1 % churn batch
     through ``update_index`` and the epoch-barrier ``swap_index``, then
     500 more. The counters are zeroed before and read after the last
     ``drain``: ``hp_join``, ``horner_push`` and ``spmm`` must launch.
     Checks: pure, monotone epochs in the batch log, no shape growth
     after warmup, no batch whose engine call raised on a worker
     (``stats()["failed"]``; the frontend sheds such a batch's tickets
     and keeps serving), a sample of tickets equal bit for bit to
     direct engines; per kind the ticket latency p50/p99, sheds, batches, fill
     and cache hit rate, the swap ms and the device bytes a replica;
  3h. node-sharded SLING, every shard on the one card (so the exchange
     between levels stays on it): ``build_index(mesh=)`` over 2 shards at
     phase 3's regime, whose d and HP table must equal phase 3's bit for
     bit; a ``QueryEngine`` with ``EngineConfig(mesh=)`` over 4 shards,
     serving phase 3's sample after ``warmup``, a 0.1 % churn batch
     through ``update_index`` and ``swap_index``, the sample again;
     ``batched_single_source_sharded`` on a 2 x 2 (data, model) mesh;
     ``run_join(JoinConfig(k=16, tile=64, mesh=))`` over phase 3f's
     4,096-source subset; phase 3e's mapped 10^6 index sharded 4 ways
     with batches of 2 and 8 that hold the hub. The counters are zeroed
     before the build and read after the last batch:
     ``horner_push_slabs`` (one launch a sharded push), ``spmm`` and
     ``hp_join`` must launch. Checks: no shape growth,
     ``swap_recompiles == 0``; the answers within BACKEND_ATOL of phase
     3's engine (before the swap), of a one-device engine on the
     repaired index (after), of phase 3f's rows and of phase 3e's
     engine, top-k ids equal outside near-ties; then the kernel and host
     launches of one sharded push (S = 4, B = 8) from a trace of ten,
     and the device's busy share;
  3i. the paper's comparison and the sling-serve config at full size:
     on ``barabasi_albert(3000, 4)`` (the reference benchmarks' largest
     size) a SLING index at eps = 0.15, ``montecarlo.build(eps=0.15,
     n_w_override=2000)`` and ``linearize.build(R=100)`` (T = 11, L =
     3); per-query times of 200 pairs through ``query_pairs``,
     ``query_pairs_kernel``, Monte Carlo and Linearize, and of 5
     sources through ``single_source_device``, ``single_source_naive``
     (n pair joins), Monte Carlo and Linearize; ``query_pairs_kernel``
     and ``ops.spmm`` held to their ``_reference`` twins (TOL_KERNEL);
     then on a 1,000-node twin every method's max error against host
     ``power.all_pairs`` (SLING's must stay within eps; the others are
     reported), Linearize's diagonal-dominance margin on ``cycle(4)``
     (must be negative), ``estimate_simrank_by_walks`` on three pairs
     within 0.02 of power and ``walk_positions`` (a stopped walk stays
     stopped, each step to an in-neighbour). Last, ``sling_paper.
     full()``: ``powerlaw_fast(10^6, k=16)``, a float32
     ``build_index_scale`` at phase 3e's eps, and ``sling_serve_step``
     on 1,024 seeded sources at l_max = 12 in one push launch (its
     first 8 rows within TOL_KERNEL of the plain push, the result left
     on the card), with its device time, bound and device peak. The
     counters are zeroed before and read after each part; ``hp_join``,
     ``spmm`` and ``horner_push`` must launch; then the plain push of
     all 1,024 rows (in 8 batches of 128) and 13 levels of
     ``torch.sparse.mm`` on a (10^6, 1,024) frontier, timed;
  3j. xDeepFM training at full width: ``recsys.init_params(xdeepfm.
     full())`` on the card from a seeded generator, then ``fit`` for 6
     steps on ``RecsysStream`` batches of 65,536 rows with mh_ids
     (``AdamW(lr=cosine_schedule(3e-3, 10, 6))``, the CLI's), each loss
     printed and finite, the step time (CUDA events from the batch's
     copy to the loss's read) p50 and max, the device peak. The
     counters are zeroed before and read after ``fit``: ``cin`` and the
     three gradient kernels (``cin_grad_x0``, ``cin_grad_xk``,
     ``cin_grad_w``) must launch. One more step by parts, traced:
     forward, backward and AdamW by CUDA events, the device time by
     kernel family (cin, index, fill, gemm, other) and of each ``cin``
     mode and its launches (``cin_mode``: layer, stream, wgrad, dx0,
     gt, g2, split, sum), the g pre-passes of dW and dx0 on lines of
     their own, the traced step's device peak; the step must run the
     dx0, wgrad, gt, g2 and layer modes and never the streamed layer.
     Then, outside the counts, each gradient kernel against its
     plain version on the card at B = 512 (the model's embeddings and
     O(1) inputs) and on a 4,096-row slice of a train batch (the plain
     dx0 materialises (B, 200, 200, 10): 13 GB in float64 there, 20 GB
     a layer in float32 on the whole batch), relative to max |grad|
     and against float64, bound TOL_CIN, two calls equal bits. Last, a
     checkpoint at ``xdeepfm.smoke()`` (cut: the full-width file would
     be ~5 GB): two steps, ``save``, ``restore`` into another model
     (equal bits), one more step from each (equal bits, in
     ``torch.use_deterministic_algorithms``: the embedding gradient's
     ``index_add_`` adds with atomics);
  3k. the GNN stack on the card (``models/gnn.py``; plain torch ops,
     as the reference's are XLA scatters): (a) full_graph_sm
     (``GNN_SHAPE_DEFS``: 2,708 nodes, d_feat 1,433) on
     ``barabasi_albert(2708, 2)``, each of gcn-cora, gat-cora, pna and
     graphcast at ``full()`` with d_in = d_feat (graphcast at its 16
     layers x 512 on ``_gnn_cell``'s layout: n grid nodes, the mesh on
     n mesh nodes, 2n g2m and 2n m2g edges, seeded; its mesh is
     ``grid2d(52, 52)``, 2,704 nodes and 10,608 edges, since through the
     BA graph's hubs its residual sums overflow float32 at random
     init), one warm-up and 5
     timed ``gnn_train_step``s with ``AdamW(lr=1e-3)``: every loss
     (finite), the step p50 and max by CUDA events, TFLOP/s by
     ``gnn_model_flops``, the ``gnn_infer_step`` p50 and the device
     peak, parameters and outputs on the card; (b) minibatch_lg:
     ``sample_subgraph`` on phase 3's Enron graph, 1,024 seeded seeds,
     fanout (15, 10), n_pad = 169,984 and m_pad = 168,960, ``knn=``
     phase 3f's all-source ``KnnGraph`` loaded from its file (host
     seconds, N and M), then gcn-cora, gat-cora and pna at ``full()``
     with d_in = 602 take 3 steps on it (features and labels drawn on
     the card from a seeded generator), the same lines. GraphCast is
     left out of (b): at 16 x 512 over 339,968 nodes its saved
     activations come to roughly 60-70 GB. Then a checkpoint at
     ``gcn-cora`` ``smoke()`` (two steps, ``save``, ``restore`` into
     another model with equal bits, one more step from each with equal
     bits under ``torch.use_deterministic_algorithms``), and last
     ``examples/torch_train_gnn_simrank.py`` on the card with the
     counters zeroed before and read after: its ``build_index`` must
     launch ``spmm`` and its ``run_join`` ``horner_push``;
  3l. the LM stack (``repro_torch.models.transformer``; no kernel of the
     port: the reference's flash attention and MoE are XLA ops) at the
     published widths, seeded weights, ``TokenStream`` data, times by
     CUDA events, each with tokens/s, TFLOP/s by ``lm_model_flops`` and
     the device peak, every config's wq / wk / wv scaled to fan_in
     d_model (``lm_params``): smollm-135m whole (30 layers) -- train_4k
     (S = 4,096) at B = 32 of the cell's 256 (1 warm-up and 2 timed
     ``lm_train_step``s, every loss finite), prefill_32k at B = 2 (1 + 1
     calls), decode_32k from that prefill's cache repeated to the
     largest power-of-two batch up to 128 that fits 85 % of the free
     memory (1 + 8 token steps near the end of 32,768 slots), long_500k
     at B = 1 on a 524,288-slot cache drawn from a seeded generator (1 +
     8); then gemma3-1b whole (26 layers, window 512, every 6th layer
     global): prefill at S = 32,768, B = 1, and decode at the batch that
     fits; then qwen3-14b, mixtral-8x22b and llama4-scout-17b-a16e at
     their widths cut to 2 layers (each layer is its own period), every
     expert held: prefill at S = 4,096, B = 1, and 1 + 4 decode steps.
     For every config one decoded token against ``forward`` over the
     prompt plus that token, all layers (``lm_agreement``: float32
     within TOL_DECODE, bf16 within LM_BF16_DECODE bf16 ulps). Then
     the mesh part (``lm_mesh_part``): the partitioned dense-LM steps
     (``models/transformer_sharded.py``) on a (2, 2) ("data", "model")
     mesh of the card against the unpartitioned steps on the card, in
     bf16 ulps of max |ref|: smollm-135m whole, train_4k at B = 8 x
     4,096 (the loss within LM_MESH_OUT, each leaf's max |grad| within
     LM_MESH_GRAD, each gradient's entrywise distance to that step's and
     to the float32 step's printed; then 1 + 2 timed steps), then
     prefill at 4,096, B = 2, and 3 decode steps for smollm-135m (with
     the profiler's kernels and host launches of one prefill and one
     step), gemma3-1b and qwen3-14b at 2 layers: logits and the caches
     gathered from their pieces within LM_MESH_OUT; gemma3-1b whole,
     train_4k at B = 8 x 4,096 held as smollm-135m's (its loss chunks
     formed a vocabulary slice at a time; no float32 step), one step's
     peak printed beside the dry run's prediction for that cell on the
     mesh; then the MoE
     part (``moe_mesh_part``): mixtral-8x22b and llama4-scout-17b-a16e at
     their published widths, "model" splitting the experts (EP; mixtral
     also d_ff, TP, through the rules ``MOE_MESH_TP``), each in float32
     and in bf16 against the gathered steps under the same mesh rules
     (``moe_ffn``'s branch, G = 2): prefill 4,096 at B = 2 and 3 decode
     steps at LM_CUT_LAYERS, train_4k at MOE_TRAIN_LAYERS, B = 4 x 4,096
     (the loss and each leaf's max |grad|), every layer's routing
     recorded (``RouteLog``): every position of a group routes
     bit-equally; in float32 each token goes to the experts the gathered
     step sends it to, near-ties apart (``route_diff``: a margin within
     the two steps' float32 difference of the probabilities), the
     outputs and max |grad| within TOL_MOE_MESH of max |ref|; in bf16
     the ulps and the routing decisions that differ (and the first layer
     where one does) printed, LM_MESH_OUT / LM_MESH_GRAD held where none
     differs;
  3m. the sharded models (``launch/sharding.py``, ``models/gnn_sharded.py``,
     ``moe_ffn``'s mesh branch, ``restore`` under shardings; no kernel of
     the port: the reference's are XLA ops) on meshes that repeat the
     card: (a) the node-sharded GCN at the ogb_products shape
     (gcn-cora's ``full()`` with d_in = 100) on ``erdos_renyi(2,449,029,
     61,859,140)`` seeded with ``--seed`` (``powerlaw_fast`` cannot give
     that shape, ``ogb_graph``), the data from ``gnn_batch`` with
     ``--seed``, over ("data",) = 4: m and
     the edges a shard, the host time of ``build_sharded_gcn_batch``, the
     sharded loss and every leaf's gradient against the unsharded
     ``gnn.loss_fn`` on the card within TOL_SHARDED, then 1 + 5 sharded
     steps of the shardmap cell's step (``make_cell(..., variant=
     "shardmap")``: the value and gradient of ``gcn_loss_sharded``, then
     AdamW) with the step p50 / max by CUDA events, TFLOP/s by
     ``gnn_model_flops`` and the device peak; (b) the elastic resume:
     the run saved after step 3, restored under the tree_shardings of
     the two-shard mesh ``elastic.remesh`` plans (every gathered leaf
     equal bits to the saved one), two more steps within TOL_SHARDED of
     the uninterrupted run's losses; full_graph_sm's GCN on four shards
     beside the unsharded step in the same run; (c) mixtral-8x22b and
     llama4-scout cut to 2 layers, every expert held, under ("data",) =
     4: prefill 4,096 tokens (B = 1), then 1 + 4 decode steps at B = 64
     from that cache repeated; the first MoE layer's call of each
     through the mesh branch equal bit for bit to ``_moe_local`` over
     the four quarters, with each quarter's dropped assignments and the
     one-group path's; one ``lm_train_step`` under the mesh for mixtral
     cut to 1 layer at B = 4 x S = 4,096; (d) that trained model saved
     and restored under a (2, 2) mesh's ``tree_shardings``: pieces
     cover the slices their placements report, gathered equal bits;
     (e) ``gnn_mesh_part``: the partitioned GNN train step
     (``models/gnn_sharded.value_and_grad``, node rows and edge slices
     over GNN_MESH = (2, 2) of the card) of each kind at full width
     against the unpartitioned ``loss_fn`` on the card: in float64 the
     loss and each leaf's max |g| within TOL_SHARDED, every position's
     copy equal, every loss finite; in float32 the same distances printed
     beside the unpartitioned float32 step's own distance to float64
     (reordered float32 sums of these gradients differ by more than
     TOL_SHARDED: PNA's by up to 3e-4 of max |g|): gcn-cora at the
     ogb_products n and m, gat-cora at a quarter of its m, pna at a
     twentieth of n and m (uniform random edges from ``--seed``),
     graphcast on GNN_MESH_GRID's grid mesh; then GNN_MESH_STEPS
     partitioned float32 train steps, their ms, peak and the host
     launches of one;
  3n. four cells (``launch/specs.make_cell``) on a (1, 1) ("data",
     "model") mesh of the card: xdeepfm serve_p99 (the ``cin`` kernel),
     xdeepfm train_batch (its three gradient kernels), gcn-cora
     full_graph_sm (no kernel) and sling-serve serve_batch, the pod path
     (the sharded push) on phase 3i's graph and index, padded to the
     cell's n (its keys re-encoded for it). For each, the dry run's
     record first (``launch/dryrun.run_cell`` on the card's mesh: fake
     tensors, nothing allocated), then ``cell.jitted()`` on real
     tensors of the cell's shapes made from ``--seed``, each predicted
     value beside the measured one: argument bytes (distinct storages of
     the placed arguments), the device peak (the arguments plus
     ``max_memory_allocated`` above what was allocated before the step),
     the roofline step time against the p50 by CUDA events, the
     bottleneck (measured: the profiler's device busy share, "host"
     under 50 %), the port kernels' calls against their launch counters
     over one step, and the walk's ops beside the profiler's kernels and
     copies a step. It fails on argument bytes or launch counts that
     differ, and on the sling cell's first 8 rows more than TOL_KERNEL
     from the plain push on its inputs. The first steps' launches join
     the kernel rows' counts. Then one dense-LM cell on a (2, 2) mesh
     of the card (``lm_cell_3n``): smollm-135m train_4k at B = 8 of the
     cell's 256 cut to 6 of its 30 layers, the partitioned step, its real arguments made on the
     host and placed on the card a copy a position; the same
     predictions against the card, failing on argument bytes or
     launches that differ or a loss that is not finite; then
     mixtral-8x22b train_4k cut to 1 layer at B = 4 the same way
     (CELL_3N_MOE), its device peak also held within CELL_3N_PEAK of the
     prediction; then one partitioned GNN cell at ogb_products on that
     mesh (``gnn_cell_3n``): pna where the dry run of the mesh predicts a
     peak under CELL_3N_GNN_BAR GiB, else gat-cora, its arguments from
     ``cell_inputs`` on the host placed a copy a position, held the same
     way, its peak within CELL_3N_PEAK;
  3o. the static analyzer held against the card (``repro_torch.
     analysis``): its CLI with ``ANALYSIS_BASELINE_TORCH.json`` in a
     subprocess (exit 0, 0 passes skipped); then every program of its
     registry on real CUDA tensors from the registry's seed (the
     sharded ones on ``["cuda:0"] * 2``, whose fan-out takes its
     one-device route: the multi-device route's syncs, which the pass
     reports on its fake mesh, are printed beside), one warm call, then
     one call under ``torch.cuda.set_sync_debug_mode("error")`` inside
     a dispatch mode that ties each sync the card raises to its aten op
     (re-run with the check off) and the pass's own recorder, and one
     under ``"warn"`` with the warnings captured: the card's sync ops
     must equal the pass's for that program on that path (a sync raised
     outside any aten op fails the phase), and the warnings must count
     what the error mode caught; then source/kernel and topk/kernel at
     the pass's ``HBM_GEOMETRY`` (n = 10,000, B = 16) and on phase 3i's
     graph and index at B = 8: one warm call, then a call under
     ``torch.cuda.memory._record_memory_history``, whose allocations of
     at least B*n/2 float32 words must not outnumber the pass's count of
     frontier-sized writes, and whose kernel launches must equal the op
     walk's kernel calls (the 10^6 rows carry no budget). Its launches
     join the kernel rows' counts;
  4. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and on its rows: max abs error, times (CUDA
     events), the card's bound and a library call's time where one
     exists (``hp_join`` at B = 256 pairs by the profiler's device time,
     with two calls held to equal bits and ``launch_floor_ms``, a
     one-element ``add_``, beside it; ``horner_push`` at B = 8 and 16
     on the Enron engine and at B = 2 and 8 on phase 3e's 10^6 engine:
     the whole push from the row ids on the card to the (B, n) result,
     the kernel's device time, the allocations before its one launch,
     the levels it runs, two pushes held to equal bits, the bound
     (inputs read once, the result written once) and the bytes streamed
     through the levels run, ``torch.sparse.mm`` over all l_max + 1
     levels, and the kernel's time on cut inputs -- no edges, level-0
     keys only -- to split it per level; ``horner_push_slabs`` at the
     Enron regime with S = 4 and B = 8: one whole sharded push (one
     launch over every level and slab) against its plain version, two
     launches held to equal bits, the levels launched one at a time
     held to the one launch's bits, a mesh of two shards on the card
     and two on the CPU (one launch a level, the frontier exchanged)
     within TOL_KERNEL, and its top-k at k = 10 and k > n_loc through
     the merge across devices within TOL_KERNEL of the one-device
     top-k, ids equal outside near-ties; the kernel's device time, the whole sharded push
     from host ids and its kernel and host launches, the persistent
     push beside it, the bound (the ids, the rows' live entries, every
     slab's CSR and the result, once) and ``torch.sparse.mm`` of every
     slab's pull for each level that runs;
     ``spmm`` on every step of one build block and of one push
     mass-scan block, as the path calls it, with the prune threshold and
     the live-segment masks: equal bits to the dense kernel, live_out
     equal to ``segment_live``; timed on the step-3 frontiers masked,
     dense and through ``torch.sparse.mm``, and as each block's mean per
     launch, beside the bound of what the frontier needs and the dense
     bound; ``cin`` at the serve_p99 shapes, on the model's own
     embeddings and on O(1)-scale inputs, relative to max |out|, with
     two calls held to equal bits, its 3xTF32 tensor-core bound and the
     float32-FMA bound beside it, then timed at retrieval_cand's
     shapes); the three CIN gradient kernels at the same shapes (g
     unit normal): times, launches and the error against the plain
     version at B = 512 from phase 3j, the 3xTF32 bound, the plain
     version's time and ``torch.autograd.grad`` of that input through
     one ``torch.einsum`` a layer as the library call; the pre-passes
     inside dx0's and dW's times (W permuted and g by rows, split, for
     dx0; g transposed and split for dW) held to their plain versions'
     bits and timed;
  5. accuracy: on a 64-node graph built with the exact diagonal, every
     pair, single-source and top-k answer is within eps + 1e-5 of exact
     SimRank (power method), for the float32 index, an int16 index
     (quant_frac 0.25) and a bf16 index (eps 0.2, quant_frac 0.8, d in
     float32), each mapped from a v3 file and served on the card; and
     every host pair of the reduced, enhanced index;
  6. output: a ``{"kernels": [...]}`` line, the card's name and power
     limit, and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_KERNEL = 1e-5      # kernel vs plain version, float32 reduction order
EPS = 0.025            # the paper's Section-7.1 eps (c = 0.6)
BLOCK = 256            # target columns per Alg-2 frontier block
STALE_FRAC = 0.2       # eps share reserved for updates (bench_update.py)
CHURN = (0.001, 0.01)  # edges per update batch, as fractions of m
TOL_CIN = 2e-5         # CIN vs plain, relative to max |out| (float32 order)
TOL_PRIOR = 1e-5       # fused - base vs sim_w * prior (test_system.py:124)
SERVE_STEPS = (2, 20)  # serve_p99: warm-up batches, timed batches
N_CAND = 1_000_000     # retrieval_cand (launch/specs.py RECSYS_SHAPE_DEFS)
N_CHECK = 4_096        # candidates recomputed on the plain CIN
CLICK_GRAPH = (10_000, 30_000, 150_000)   # users, items, clicks
N_PRIOR_USERS = 8
QUANT_FRAC = 0.2       # eps share reserved for quantization (phase 3d)
N_SCALE = 1_000_000    # phase 3e: benchmarks/bench_space.py:148 run_scale
SCALE_EPS = 0.5        # its eps: the packed width stays ~64
# phase 3i: the paper's competitors at the reference benchmarks' largest
# size (benchmarks/bench_single_pair.py:17), errors on a smaller twin
N_BASE, N_TWIN = 3_000, 1_000
BASE_EPS = 0.15        # SLING's eps there (examples/sling_serve.py)
MC_WALKS = 2_000       # Monte Carlo walks a node (n_w_override)
LIN_R = 100            # Linearize's walks a node (T = 11, L = 3)
N_PAIR_Q, N_SOURCE_Q = 200, 5
TRAIN_STEPS = 6        # phase 3j: fit steps at full width, B = 65,536
N_SLICE = 4_096        # rows of a train batch held against the plain grads
# phase 3k: the GNN stack (launch/specs.py GNN_SHAPE_DEFS)
GNN_ARCHS = ("gcn-cora", "gat-cora", "pna", "graphcast")
GNN_STEPS = (1, 5)     # full_graph_sm: warm-up steps, timed steps
LG_STEPS = (1, 2)      # minibatch_lg: 3 steps, the first a warm-up
LG_SEEDS, LG_FANOUT = 1_024, (15, 10)
MESH_GRID = (52, 52)   # graphcast's mesh: 2,704 nodes, 10,608 edges
# phase 3l: the LM stack (launch/specs.py LM_SHAPE_DEFS)
LM_TRAIN_STEPS = (1, 2)    # train_4k: warm-up steps, timed steps
LM_PREFILL_STEPS = (1, 1)  # prefill: warm-up calls, timed calls
LM_DECODE_STEPS = (1, 8)   # decode_32k / long_500k: warm-up, timed tokens
LM_CUT_DECODE = (1, 4)     # the depth-cut configs after their prefill
LM_CUT_LAYERS = 2          # qwen3 / mixtral / scout: each layer its own period
LM_CUT_PREFILL = 4_096
LM_TRAIN_BATCH = 32        # train_4k's batch, cut from the cell's 256
LM_MEM_SHARE = 0.85        # of the memory free when a decode batch is sized
TOL_DECODE = 1e-4          # decode vs forward, float32: of max |logit|
# phase 3m: the sharded models (launch/specs.py GNN_SHAPE_DEFS)
OGB_SHARDS = 4             # node shards of the card ("data",)
OGB_STEPS = (1, 5)         # warm-up steps, timed steps
RESUME_AT = 3              # the elastic resume: saved after this step
TOL_SHARDED = 1e-5         # sharded vs unsharded: of the loss, of max |g|
MOE_GROUPS = 4             # the MoE mesh: ("data",) = 4 on the card
MOE_DECODE_B = 64
MOE_TRAIN_LAYERS = 1       # the mesh train step: mixtral cut to one layer
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH = 4_096, 4
# its GNN part: each kind's partitioned step on a (2, 2) ("data",
# "model") mesh of the card against the unpartitioned step, in float64
# and float32, at full width on uniform random edges: (arch, the
# ogb_products n and m divided by), sized so that the unpartitioned
# float64 step fits: gcn-cora at the full shape (float32 9.8 GiB above
# its batch); gat-cora at a quarter of its edges (77.2 GiB predicted at
# the full m in float32); pna at a twentieth of n and m (474 GiB at the
# full shape); graphcast on GNN_MESH_GRID
GNN_MESH = (2, 2)
GNN_MESH_CASES = (("gcn-cora", 1, 1), ("gat-cora", 1, 4), ("pna", 20, 20))
GNN_MESH_GRID = (176, 176)     # graphcast's mesh: 30,976 nodes, 123,200 edges
GNN_MESH_STEPS = (1, 2)        # partitioned train steps: warm-up, timed
BF16_ULP = 2.0 ** -7       # of max |logit|: bf16's spacing at a significand of 1
LM_BF16_DECODE = 8         # decode vs forward, bf16: in BF16_ULPs
# phase 3l's mesh part: the partitioned dense-LM steps on a (2, 2)
# ("data", "model") mesh of the one card, against the unpartitioned ones
LM_MESH = (2, 2)
LM_MESH_SEQ = 4_096
LM_MESH_TRAIN_B = 8        # train_4k's batch, cut from the cell's 256
LM_MESH_TRAIN_STEPS = (1, 2)
LM_MESH_GEMMA_STEPS = (0, 1)   # gemma3-1b's: the one step that its peak needs
LM_MESH_SERVE_B = 2        # prefill / decode: one row a data group
LM_MESH_DECODE = 3         # decode steps after the prefill
LM_MESH_OUT, LM_MESH_GRAD = 4, 8   # bf16 ulps: outputs, each leaf's grad
# its MoE part: at the published widths, against the gathered steps under
# the same mesh rules; mixtral also with d_ff over "model" (TP)
MOE_MESH_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
MOE_MESH_TP = {"experts_w": [None]}
TOL_MOE_MESH = 1e-4        # float32: of max |ref| (outputs, max |grad|)
# phase 3n: the cells on the card's (1, 1) mesh, and their steps
# (warm-up, timed)
CELLS_3N = (("xdeepfm", "serve_p99", (1, 5)),
            ("xdeepfm", "train_batch", (1, 2)),
            ("gcn-cora", "full_graph_sm", (1, 5)),
            ("sling-serve", "serve_batch", (1, 1)))
# and one dense-LM cell on a (2, 2) mesh of the card: (arch, shape,
# (warm-up, timed) steps, the batch cut from the cell's, the layers cut
# to: the dry run of 30 layers on four positions takes ~60 s)
CELL_3N_LM = ("smollm-135m", "train_4k", (1, 2), 8, 6)
# and one MoE-LM cell, cut to MOE_TRAIN_LAYERS; a cut cell's peak is
# held to the prediction within CELL_3N_PEAK
CELL_3N_MOE = ("mixtral-8x22b", "train_4k", (1, 2), 4, 1)
CELL_3N_PEAK = 0.10
# and one partitioned GNN cell at ogb_products: the first of these whose
# dry run on the (2, 2) mesh predicts a peak under CELL_3N_GNN_BAR GiB
CELL_3N_GNN = ("pna", "gat-cora")
CELL_3N_GNN_BAR = 70.0
CELL_3N_GNN_STEPS = (1, 2)
# a kernel row's keys beyond the contract's, printed beside it
ROW_EXTRAS = ("call_ms", "launch_floor_ms", "launch_floor_device_ms",
              "steps", "levels_run", "push_ms", "alloc_ms",
              "streamed_bound_ms", "b16", "parts", "launches_per_push",
              "host_launches_per_push", "push_busy_pct",
              "persistent_push_ms", "push_err",
              "levels_one_at_a_time_equal", "mixed_mesh_err",
              "mixed_mesh_launches", "mixed_mesh_topk", "rel_err",
              "train_step_mode_ms", "prepass_ms")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn):
    """(fn's result, device ms from its call to its result being ready:
    CUDA events, the end event waited on)."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls (CUDA events, after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():     # each result freed before the next call, as a loop does
        for _ in range(reps):
            fn()
    _, t = events_ms(run)
    return t / reps


def pct(lat_s: list[float]) -> str:
    import numpy as np
    a = 1e3 * np.asarray(lat_s)
    return (f"p50 {np.percentile(a, 50):.3f} ms p99 "
            f"{np.percentile(a, 99):.3f} ms")


def trace(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler and print the device's busy share
    of the window (the device time of kernels and copies over the wall
    time) and the top rows by device and by CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side rows only (kernels, copies, memsets), as the table's
    # own "Self CUDA time total"; an aten op's row repeats its kernels
    dev = sum(r.self_device_time_total for r in rows
              if r.device_type == DeviceType.CUDA
              and not getattr(r, "is_user_annotation", False)) / 1e6
    print(f"[profile] {label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{dev * 1e3:.3f} ms ({100 * dev / wall:.1f}%)")
    for sort_by in ("self_device_time_total", "cpu_time_total"):
        for line in rows.table(sort_by=sort_by, row_limit=15).splitlines():
            print(f"[profile] {line}")


# the runtime calls that put work on a stream, as the profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def launch_census(fn, reps: int) -> dict:
    """What one call of ``fn`` launches, from a torch.profiler trace of
    ``reps`` calls after a warm one: device kernels (device rows other
    than copies and memsets), host launches (the runtime calls of
    HOST_LAUNCHES, by name), the wall time a call and the device's busy
    time and share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [r for r in rows if r.device_type == DeviceType.CUDA
           and not getattr(r, "is_user_annotation", False)]
    busy = sum(r.self_device_time_total for r in dev) / 1e6
    by_name = {r.key: r.count / reps for r in rows
               if r.key in HOST_LAUNCHES}
    return {"kernels": sum(r.count for r in dev if not r.key.startswith(
                ("Memcpy", "Memset"))) / reps,
            "host": sum(by_name.values()), "by_name": by_name,
            "wall_ms": wall / reps * 1e3, "busy_ms": busy / reps * 1e3,
            "busy_pct": 100 * busy / wall}


def profile_serving(eng, q) -> None:
    """Trace 4 pair, 4 single-source and 4 top-k batches (fresh nodes,
    so no cache hits)."""
    def run():
        for lo in range(0, 32, 8):
            eng.pairs(q[lo:lo + 8], q[lo + 32:lo + 40])
            eng.single_source(q[lo:lo + 8])
            eng.topk(q[lo + 32:lo + 40], 10)
    trace("12 batches", run)


def table_rows_vs_fresh(hp, fresh, rows, targets, theta: float) -> dict:
    """Hold the rows ``rows`` of a repaired table, restricted to entries
    whose target is in ``targets``, against a fresh table: keys must be
    equal and values within TOL_KERNEL; an entry on one side only is
    allowed (and counted) only within float32 rounding of theta."""
    import torch
    dev = hp.keys.device
    n = hp.n
    r = torch.as_tensor(rows, device=dev)
    tg = torch.sort(torch.as_tensor(targets, device=dev)).values

    def coo(t):
        k, v = t.keys[r], t.vals[r]
        live = (torch.arange(t.width, device=dev)[None, :]
                < t.counts[r].long()[:, None])
        ri, ci = torch.nonzero(live & torch.isin(k.long() % n, tg),
                               as_tuple=True)
        code = r[ri] * (1 << 31) + k[ri, ci].long()
        order = torch.argsort(code)
        return code[order], v[ri, ci][order]

    ca, va = coo(hp)
    cb, vb = coo(fresh)
    in_b, in_a = torch.isin(ca, cb), torch.isin(cb, ca)
    only = torch.cat([va[~in_b], vb[~in_a]])
    near = (only - theta).abs() <= 4e-7 * theta
    shared_err = float((va[in_b] - vb[in_a]).abs().max()) if \
        int(in_b.sum()) else 0.0
    return {"entries": len(ca), "fresh_entries": len(cb),
            "one_side_only": len(only), "at_theta": int(near.sum()),
            "max_abs_err": shared_err,
            "bit_equal": bool(len(only) == 0 and torch.equal(va, vb)),
            "ok": bool(near.all()) and shared_err <= TOL_KERNEL}


class _Clock:
    """Per-call milliseconds: CUDA events on the card, the host clock
    (after the call returns) on the CPU, where the phase is rehearsed."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __call__(self, fn):
        if not self.cuda:
            t = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t) * 1e3
        return events_ms(fn)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def xdeepfm_phase(dev, cfg=None, n_cand: int = N_CAND,
                  click_graph=CLICK_GRAPH, eps: float = EPS,
                  profile: bool = False):
    """xDeepFM serving on ``dev``: serve_p99, retrieval_cand and the
    SimRank-prior retrieval (see the module docstring, phase 3c); with
    ``profile``, a trace of 4 more serve batches and of one more
    retrieval after the path's counts are read.
    Returns (the model, a serve batch, the launches of the path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import xdeepfm
    from repro_torch.core import build
    from repro_torch.core.single_source import single_source_device
    from repro_torch.core.topk import stable_topk
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.device import synchronize
    from repro_torch.graph import generators
    from repro_torch.kernels.cin import cin_layer
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.spmv_ell import HEAVY_DEGREE, spmm
    from repro_torch.launch.specs import RECSYS_SHAPE_DEFS, \
        recsys_model_flops
    from repro_torch.models import recsys
    from repro_torch.train.steps import recsys_retrieval_step, \
        recsys_serve_step

    kernels = {"cin": cin_layer, "horner_push": horner_push_rows,
               "spmm": spmm}
    path = {k: 0 for k in kernels}
    path["horner_push_steps"] = 0

    def zero():
        for kern in kernels.values():
            kern.launches = 0
        horner_push_rows.steps = 0

    def read():
        for k, kern in kernels.items():
            path[k] += kern.launches
        path["horner_push_steps"] += horner_push_rows.steps

    clock = _Clock(dev)
    cfg = cfg or xdeepfm.full()
    prior_cfg = dataclasses.replace(cfg, sim_prior=True)
    t0 = time.perf_counter()
    # one module for both configs: sim_prior adds the scalar sim_w
    model = recsys.XDeepFM(prior_cfg, generator=torch.Generator(
        device=dev).manual_seed(0))
    synchronize(dev)
    numel = sum(p.numel() for p in model.parameters())
    table_bytes = sum(p.numel() * p.element_size()
                      for p in model.tables.values())
    print(f"[xdeepfm] {cfg.name}: param_count={cfg.param_count():,} "
          f"(the module holds {numel:,}: + the scalars bias and sim_w, "
          f"which param_count leaves out, as the reference does); tables "
          f"{table_bytes / 1e9:.3f} GB; init {time.perf_counter() - t0:.2f}s")
    if numel != cfg.param_count() + 2:
        raise RuntimeError("the module's parameters differ from "
                           "param_count")

    # ---- serve_p99 ----
    B = RECSYS_SHAPE_DEFS["serve_p99"]["batch"]
    stream = RecsysStream(cfg.n_fields, cfg.vocab_per_field, B,
                          multi_hot_fields=cfg.multi_hot_fields,
                          bag_size=cfg.bag_size)
    batches = [stream.batch_at(s) for s in range(sum(SERVE_STEPS))]
    serve = recsys_serve_step(cfg)
    zero()
    probs, lat = [], []
    for b in batches:
        p, ms = clock(lambda: serve(model, b))
        probs.append(p)
        lat.append(ms / 1e3)
    read()
    lat = lat[SERVE_STEPS[0]:]
    flops = recsys_model_flops(cfg, B, train=False)
    print(f"[xdeepfm] serve_p99: {len(lat)} batches of {B} (after "
          f"{SERVE_STEPS[0]} warm-up): per batch {pct(lat)} (CUDA events); "
          f"{flops / 1e9:.2f} GFLOP per batch")
    allp = torch.stack(probs)
    if not bool(torch.isfinite(allp).all()) or \
            float(allp.min()) < 0.0 or float(allp.max()) > 1.0:
        raise RuntimeError("serve probabilities not finite in [0, 1]")
    with torch.inference_mode():                      # check, not counted
        lk = recsys.forward(cfg, model, batches[0])
        lp = recsys.forward(cfg, model, batches[0], backend="plain")
    e_serve = rel_err(lk, lp)
    print(f"[xdeepfm] serve step 0 logits vs the plain CIN on the card: "
          f"{e_serve:.3g} of max |logit| = {float(lp.abs().max()):.4g} "
          f"(bound {TOL_CIN})")
    if not e_serve <= TOL_CIN:
        raise RuntimeError(f"serve logits disagree with plain: {e_serve}")
    if profile:
        trace(f"4 serve_p99 batches of {B}",
              lambda: [serve(model, b) for b in batches[:4]])

    # ---- retrieval_cand ----
    rng = np.random.default_rng(0)
    n_item = cfg.n_fields - cfg.n_user_fields
    rb = {"user_ids": torch.as_tensor(
              rng.integers(0, cfg.vocab_per_field, cfg.n_user_fields),
              device=dev),
          "cand_ids": torch.as_tensor(
              rng.integers(0, cfg.vocab_per_field, (n_cand, n_item)),
              device=dev)}
    retrieve = recsys_retrieval_step(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero()
    out = retrieve(model, rb)                         # warm
    secs = []
    for _ in range(3):
        del out
        t = time.perf_counter()
        out = retrieve(model, rb)
        synchronize(dev)
        secs.append(time.perf_counter() - t)
    read()
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.type == "cuda" else float("nan")
    flops = recsys_model_flops(cfg, n_cand, train=False)
    print(f"[xdeepfm] retrieval_cand: C={n_cand:,} top-128: "
          + " ".join(f"{x:.3f}s" for x in secs)
          + f" (3 reps after one warm); {flops / 1e12:.2f} TFLOP, "
          f"{flops / min(secs) / 1e12:.2f} TFLOP/s at the best rep; "
          f"peak device memory {peak:.2f} GiB (candidate ids on the card)")
    scores = out["scores"]
    sv, si = stable_topk(scores[None], 128)
    if not torch.equal(out["top_i"], si[0]) or \
            not torch.equal(out["top_v"], sv[0]) or \
            not bool(torch.isfinite(scores).all()):
        raise RuntimeError("retrieval top-128 is not the stable top-128")
    with torch.inference_mode():                      # check, not counted
        sub = {"user_ids": rb["user_ids"],
               "cand_ids": rb["cand_ids"][:N_CHECK]}
        sp = recsys.score_candidates(cfg, model, sub, backend="plain")
    e_ret = float((scores[:N_CHECK] - sp).abs().max()
                  / sp.abs().max())
    print(f"[xdeepfm] retrieval: first {N_CHECK} scores vs the plain CIN "
          f"on the card: {e_ret:.3g} of max |score| = "
          f"{float(sp.abs().max()):.4g} (bound {TOL_CIN}); top score "
          f"{float(out['top_v'][0]):.6g} at candidate "
          f"{int(out['top_i'][0])}")
    if not e_ret <= TOL_CIN:
        raise RuntimeError(f"retrieval scores disagree with plain: {e_ret}")
    if profile:
        del out
        trace(f"one retrieval_cand step, C={n_cand:,}",
              lambda: retrieve(model, rb))
        out = None
    del out, scores, rb, sub, sp

    # ---- the SLING SimRank prior over a click graph ----
    n_users, n_items, clicks = click_graph
    g = generators.bipartite(n_users, n_items, clicks, seed=0)
    zero()
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=eps, c=0.6, seed=0, block=BLOCK,
                            device=dev)
    t_build = time.perf_counter() - t0
    clicked_any = np.flatnonzero(g.in_deg[:n_users] > 0)
    users = np.sort(rng.choice(clicked_any, N_PRIOR_USERS, replace=False))
    # a user and an item never meet on a bipartite graph (their reverse
    # walks are on opposite sides at every step), so a user's SimRank to
    # every item is 0; an item each user clicked is a second source,
    # whose item-to-item scores are the prior that is not zero
    items = np.array([rng.choice(g.in_neighbors(u)) for u in users])
    sources = np.concatenate([users, items])
    t0 = time.perf_counter()
    sim = single_source_device(idx, g, sources, device=dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = single_source_device(idx, g, sources, device=dev)
    t_warm = time.perf_counter() - t0
    item_ids = torch.as_tensor(rng.integers(0, cfg.vocab_per_field,
                                            (n_items, n_item)), device=dev)
    fused_step = recsys_retrieval_step(prior_cfg)
    base, fused, lat = [], [], []
    for u in range(len(users)):
        ub = {"user_ids": torch.as_tensor(rng.integers(
                  0, cfg.vocab_per_field, cfg.n_user_fields), device=dev),
              "cand_ids": item_ids}
        base.append(retrieve(model, ub)["scores"])
        for row in (u, len(users) + u):     # the user's, the item's prior
            t = time.perf_counter()
            fused.append(fused_step(model, {
                **ub, "sim_scores": torch.as_tensor(sim[row, n_users:],
                                                    device=dev)})["scores"])
            synchronize(dev)
            lat.append(time.perf_counter() - t)
    read()
    p = idx.plan
    deg = g.in_deg
    print(f"[prior] click graph bipartite{click_graph}: n={g.n} m={g.m} "
          f"max in-degree={int(deg.max())} rows of in-degree > "
          f"{HEAVY_DEGREE}: {int((deg > HEAVY_DEGREE).sum())}")
    print(f"[prior] build_index eps={p.eps} c={p.c}: l_max={p.l_max} "
          f"d={idx.build_seconds['d']:.2f}s hp={idx.build_seconds['hp']:.2f}s"
          f" total={t_build:.2f}s width={idx.hp.width}; "
          f"single_source_device({len(users)} users + their "
          f"{len(items)} clicked items) first {t_first * 1e3:.2f} ms, warm "
          f"{t_warm * 1e3:.2f} ms; fused retrieval over {n_items:,} items "
          f"per call {pct(lat)}")
    w = float(model.recsys.sim_w)
    e_prior = max(float((fused[2 * u + k] - base[u] - w * torch.as_tensor(
        sim[k * len(users) + u, n_users:], device=dev)).abs().max())
        for u in range(len(users)) for k in (0, 1))
    e_sim = float(np.abs(single_source_device(          # not counted
        idx, g, sources, backend="plain", device=dev) - sim).max())
    user_mass = np.abs(sim[:len(users), n_users:]).sum(1)
    item_mass = sim[len(users):, n_users:].sum(1)
    print(f"[prior] fused - base vs sim_w * prior: max {e_prior:.3g} "
          f"(bound {TOL_PRIOR}); single_source_device vs the plain push "
          f"on the card: {e_sim:.3g}; prior mass on the items: from each "
          f"user {user_mass.tolist()}, from each clicked item "
          f"{np.round(item_mass, 4).tolist()}")
    if not e_prior <= TOL_PRIOR or not e_sim <= TOL_KERNEL or \
            user_mass.any() or not (item_mass > 0).all():
        raise RuntimeError(f"prior retrieval is off: {e_prior}, {e_sim}, "
                           f"{user_mass}, {item_mass}")
    if min(path.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the xDeepFM path: "
                           f"{path}")
    del idx, base, fused
    return model, batches[0], path


def cin_row(model, batch, dev, launches: int) -> dict:
    """``cin`` against its plain version at the serve_p99 shapes (the
    three layers of one batch), on the model's own embeddings and on
    O(1)-scale inputs (x0, xk unit normal, W / sqrt(h*m)): errors
    relative to max |out| (and both versions against float64), equal
    bits from two calls, times, one ``torch.einsum`` per layer (TF32
    off), and the bounds: the kernel's own, 3xTF32 operations on the
    tensor cores, and beside it float32 FMA. Then the three layers at
    retrieval_cand's shapes (N_CAND candidates, O(1) inputs), timed."""
    import torch

    from repro_torch.kernels.cin import cin_layer, cin_layer_ref
    from repro_torch.kernels.cin.cin import (cin_layer_cost, split_weights,
                                             split_weights_on_card)
    from repro_torch.kernels.cost import KernelCost, total
    from repro_torch.models import recsys

    cfg = model.cfg
    with torch.inference_mode():
        x0 = recsys.embed(cfg, model, batch)
        Ws = [w.detach() for w in model.recsys.cin_w]
        # each layer's input: the plain version's output of the layer
        # before, so kernel and plain see the same inputs
        xs = [x0]
        for W in Ws[:-1]:
            xs.append(cin_layer(x0, xs[-1], W, backend="plain"))
        gen = torch.Generator(device=dev).manual_seed(1)
        unit = [(torch.randn(x0.shape, generator=gen, device=dev),
                 torch.randn(xk.shape, generator=gen, device=dev),
                 torch.randn(W.shape, generator=gen, device=dev)
                 / math.sqrt(W.shape[1] * W.shape[2]))
                for xk, W in zip(xs, Ws)]
        errs = {"model": [], "unit": []}
        abs_err = 0.0
        for name, cases in (("model", [(x0, xk, W) for xk, W in
                                       zip(xs, Ws)]), ("unit", unit)):
            for a, xk, W in cases:
                got = cin_layer(a, xk, W)
                ref = cin_layer(a, xk, W, backend="plain")
                r64 = cin_layer_ref(a.double(), xk.double(), W.double())
                if name == "model":
                    abs_err = max(abs_err, float((got - ref).abs().max()))
                errs[name].append((rel_err(got, ref), rel_err(got, r64),
                                   rel_err(ref, r64)))
        same = all(torch.equal(cin_layer(x0, xk, W), cin_layer(x0, xk, W))
                   for xk, W in zip(xs, Ws))
        # the W split inside each call: the kernel the wrapper launches,
        # and its plain version's torch ops (equal bits)
        split_same = all(torch.equal(split_weights_on_card(W),
                                     split_weights(W)) for W in Ws)
        split_ms = time_ms(lambda: [split_weights_on_card(W) for W in Ws], 50)
        split_plain_ms = time_ms(lambda: [split_weights(W) for W in Ws], 50)
        # the layers' cost (kernels/cin/cin.py): three TF32 products per
        # multiply-add on the tensor cores; beside it float32 FMA
        B, m, D = x0.shape
        cost = total(cin_layer_cost(x0, xk, W) for xk, W in zip(xs, Ws))
        ops = cost.flops
        b_ms, b_by = cost.bound_ms()
        fma_ms, _ = KernelCost(cost.bytes, cost.flops).bound_ms()

        def run(backend):
            return lambda: [cin_layer(x0, xk, W, backend=backend)
                            for xk, W in zip(xs, Ws)]

        def library():
            return [torch.einsum("ihm,bhd,bmd->bid", W, xk, x0)
                    for xk, W in zip(xs, Ws)]

        e_lib = max(rel_err(y, cin_layer(x0, xk, W, backend="plain"))
                    for y, xk, W in zip(library(), xs, Ws))
        row = {"name": "cin", "route": "cuda",
               "source": "src/repro_torch/csrc/cin.cu",
               "replaces": "src/repro/kernels/cin/cin.py:37",
               "launches": launches, "max_abs_err": abs_err,
               "ms": time_ms(run("auto"), 50),
               "plain_ms": time_ms(run("plain"), 10),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(library, 10),
               "fma_bound_ms": fma_ms,
               "shape": f"B={B} m={m} D={D} layers "
                        + "-".join(str(W.shape[1]) for W in Ws)
                        + f"-{Ws[-1].shape[0]}"}
        del unit, cases
        xr = torch.randn((N_CAND, m, D), generator=gen, device=dev)
        w_unit = [torch.randn(W.shape, generator=gen, device=dev)
                  / math.sqrt(W.shape[1] * W.shape[2]) for W in Ws]

        def retrieval_layers():
            xk = xr
            for W in w_unit:
                xk = cin_layer(xr, xk, W)
            return xk

        r_ms = time_ms(retrieval_layers, 2)
        r_ops = ops / B * N_CAND
        del xr
    for name, es in errs.items():
        print(f"[kernel] cin on {name} inputs, per layer, relative to max "
              f"|out|: kernel vs plain / kernel vs float64 / plain vs "
              f"float64: " + "; ".join(" / ".join(f"{e:.3g}" for e in t)
                                       for t in es))
    print(f"[kernel] cin: the einsum library call vs plain {e_lib:.3g}; "
          f"serve_p99 {ops / 1e9:.2f} GFLOP, kernel at "
          f"{ops / row['ms'] / 1e9:.2f} TFLOP/s; bounds: 3xTF32 on the "
          f"tensor cores {b_ms:.4f} ms, float32 FMA {fma_ms:.4f} ms; two "
          f"calls give equal bits: {same}")
    print(f"[kernel] cin W split (3 layers, inside the kernel's ms): the "
          f"cin_split kernel {split_ms:.4f} ms, its plain torch ops "
          f"{split_plain_ms:.4f} ms; equal bits: {split_same}")
    print(f"[kernel] cin at retrieval_cand (C={N_CAND:,}, 3 layers, one "
          f"call each): {r_ms:.3f} ms, {r_ops / 1e12:.2f} TFLOP, kernel at "
          f"{r_ops / r_ms / 1e9:.2f} TFLOP/s")
    worst = max(t[0] for es in errs.values() for t in es)
    if not worst <= TOL_CIN:
        raise RuntimeError(f"cin disagrees with its plain version: {worst}")
    if not same:
        raise RuntimeError("two cin calls on the same inputs differ")
    if not split_same:
        raise RuntimeError("cin_split disagrees with split_weights")
    return row


def cin_stream_check(dev) -> None:
    """The layer kernel's mode with x0 read from device memory (x0 wider
    than its shared-memory slab, m = 200; no main path runs it since
    dx0 has its own kernel): one layer at B = 512 with the shapes of a
    200-wide layer's dx0 as the layer kernel once took them, x0 and xk
    (512, 200, 10) and W (39, 200, 200), O(1) inputs, held against its
    plain version and float64 within TOL_CIN of max |out|, with the
    profiler's kernel names showing the mode it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cin import cin_layer, cin_layer_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    x0, xk = (torch.randn((512, 200, 10), generator=gen, device=dev)
              for _ in range(2))
    W = torch.randn((39, 200, 200), generator=gen, device=dev) / 200.0
    with torch.inference_mode():
        got = cin_layer(x0, xk, W)
        e_plain = rel_err(got, cin_layer(x0, xk, W, backend="plain"))
        e64 = rel_err(got, cin_layer_ref(x0.double(), xk.double(),
                                         W.double()))
        ms = time_ms(lambda: cin_layer(x0, xk, W), 20)
        modes = set()
        for _ in range(3):   # the profiler may keep no record of a window
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cin_layer(x0, xk, W)
                torch.cuda.synchronize()
            modes = {cin_mode(r.key) for r in prof.key_averages()
                     if r.device_type == DeviceType.CUDA
                     and "cin_kernel" in r.key.lower()}
            if modes:
                break
    print(f"[kernel] cin with x0 streamed (m = 200, B = 512): vs plain "
          f"{e_plain:.3g}, vs float64 {e64:.3g} of max |out|, "
          f"{ms:.4f} ms; the profiler's cin_kernel modes: "
          f"{sorted(modes) or 'no record in 3 windows'}")
    if not max(e_plain, e64) <= TOL_CIN:
        raise RuntimeError(f"cin with x0 streamed disagrees with its plain "
                           f"version: {e_plain}, {e64}")
    if modes and modes != {"stream"}:
        raise RuntimeError(f"a 200-wide x0 ran cin_kernel's modes {modes}, "
                           f"not the streamed one")


GRAD_KERNELS = ("cin_grad_x0", "cin_grad_xk", "cin_grad_w")


# the parts of csrc/cin.cu by kernel name: cin_kernel's three modes (the
# layer with x0's slab, the layer with x0 streamed, dW), dx0's kernel,
# dW's and dx0's g pre-passes, the W splits (the layer's and dx0's), the
# chunk sum
CIN_MODES = ("layer", "stream", "wgrad", "dx0", "gt", "g2", "split", "sum")


def cin_mode(name: str) -> str:
    """The part of ``csrc/cin.cu`` a kernel name (demangled, mangled or
    lower-cased) belongs to, one of CIN_MODES; a name it does not know
    is returned as it is, so a new kernel shows under its own name."""
    low = name.lower()
    if "cin_kernel" in low:
        for mode, k in zip(CIN_MODES, range(3)):
            if f"<{k}>" in low or f"ili{k}e" in low:
                return mode
    for mode, tag in (("dx0", "cin_x0grad_kernel"), ("gt", "cin_split_gt"),
                      ("g2", "cin_split_g"), ("split", "cin_split"),
                      ("sum", "cin_sum_chunks")):
        if tag in low:
            return mode
    return name


def grad_cases(model, batch, dev, seed: int):
    """The CIN gradient kernels' inputs of one batch, per layer: on the
    model's own embeddings (x0, each layer's xk from the plain layer
    before, W the model's) and on O(1)-scale inputs (unit normal x0 and
    xk, W / sqrt(h*m)), both with a unit-normal g = dL/dout."""
    import torch

    from repro_torch.kernels.cin import cin_layer
    from repro_torch.models import recsys

    cfg = model.cfg
    with torch.no_grad():
        x0 = recsys.embed(cfg, model, batch)
        Ws = [w.detach() for w in model.recsys.cin_w]
        xs = [x0]
        for W in Ws[:-1]:
            xs.append(cin_layer(x0, xs[-1], W, backend="plain"))
        gen = torch.Generator(device=dev).manual_seed(seed)
        gs = [torch.randn((x0.shape[0], W.shape[0], x0.shape[2]),
                          generator=gen, device=dev) for W in Ws]
        unit = [(torch.randn(x0.shape, generator=gen, device=dev),
                 torch.randn(xk.shape, generator=gen, device=dev),
                 torch.randn(W.shape, generator=gen, device=dev)
                 / math.sqrt(W.shape[1] * W.shape[2]), g)
                for xk, W, g in zip(xs, Ws, gs)]
    return {"model": [(x0, xk, W, g) for xk, W, g in zip(xs, Ws, gs)],
            "unit": unit}


def grad_checks(label: str, cases: dict) -> dict:
    """Each gradient kernel against its plain version
    (``cin_layer_backward_plain``, whose (dx0, dxk, dW) are
    GRAD_KERNELS' order) on the card, layer by layer: errors relative to
    the gradient's max |value| (kernel vs plain, kernel vs float64, plain
    vs float64), equal bits from two calls. Raises past TOL_CIN. Returns
    {kernel: (max abs error, max relative error)} vs plain on the model's
    inputs."""
    import torch

    from repro_torch.kernels import cin as kcin
    from repro_torch.kernels.cin import cin_layer_backward_plain

    fns = [getattr(kcin, k) for k in GRAD_KERNELS]
    model_err = {k: (0.0, 0.0) for k in GRAD_KERNELS}
    worst, same = 0.0, True
    with torch.no_grad():
        for name, layers in cases.items():
            errs = {k: [] for k in GRAD_KERNELS}
            for args in layers:
                wants = cin_layer_backward_plain(*args)
                r64s = cin_layer_backward_plain(*(a.double() for a in args))
                for k, fn, want, r64 in zip(GRAD_KERNELS, fns, wants, r64s):
                    got = fn(*args)
                    rel = rel_err(got, want)
                    errs[k].append((rel, rel_err(got, r64),
                                    rel_err(want, r64)))
                    if name == "model":
                        a, r = model_err[k]
                        model_err[k] = (max(a, float(
                            (got - want).abs().max())), max(r, rel))
                    same = same and torch.equal(got, fn(*args))
                    worst = max(worst, rel)
                    del got
                del wants, r64s
            for k in GRAD_KERNELS:
                print(f"[train] {label} {k} on {name} inputs, per layer, "
                      f"relative to max |grad|: kernel vs plain / kernel vs "
                      f"float64 / plain vs float64: "
                      + "; ".join(" / ".join(f"{e:.3g}" for e in t)
                                  for t in errs[k]))
    print(f"[train] {label}: worst kernel vs plain {worst:.3g} (TOL_CIN "
          f"{TOL_CIN}); two calls give equal bits: {same}")
    if not worst <= TOL_CIN or not same:
        raise RuntimeError(f"a cin gradient kernel disagrees with its plain "
                           f"version at {label}: {worst}, equal bits {same}")
    return model_err


def train_state(model, opt_state) -> list:
    """Copies of a model's leaves and its AdamW state, in order."""
    from repro_torch.optim.adamw import named_leaves
    return ([p.detach().clone() for _, p in named_leaves(model)]
            + [opt_state.step.clone()]
            + [t.clone() for t in opt_state.m.values()]
            + [t.clone() for t in opt_state.v.values()])


def same_bits(a: list, b: list) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def checkpoint_check(dev, tmp) -> None:
    """A checkpoint at ``xdeepfm.smoke()`` on the card (the full-width
    file would be ~5 GB): two train steps, ``save``, ``restore`` into a
    model drawn from another seed (equal bits), then one more step from
    the unsaved state and one from the restored state, which must give
    equal bits. The embedding gradient's ``index_add_`` adds with
    atomics on the card, so both steps run under
    ``torch.use_deterministic_algorithms``; without it, two steps are
    compared and the result printed."""
    import torch

    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.models import recsys
    from repro_torch.optim.adamw import AdamW, named_leaves
    from repro_torch.train import checkpoint
    from repro_torch.train.steps import recsys_train_step

    cfg = xdeepfm.smoke()
    opt = AdamW(lr=1e-3)
    step = recsys_train_step(cfg, opt)
    stream = RecsysStream(cfg.n_fields, cfg.vocab_per_field, 256,
                          cfg.multi_hot_fields, cfg.bag_size)

    a = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sa = opt.init(a)
    for k in range(2):
        a, sa, _ = step(a, sa, stream.batch_at(k))
    ckpt = str(Path(tmp) / "ckpt")
    t0 = time.perf_counter()
    checkpoint.save(ckpt, 1, a, sa, extra={"cursor": 2})
    t_save = time.perf_counter() - t0
    b = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    sb = opt.init(b)
    b, sb, mf = checkpoint.restore(ckpt, checkpoint.latest_step(ckpt), b, sb)
    restored = same_bits(train_state(a, sa), train_state(b, sb))
    batch = stream.batch_at(2)
    saved = train_state(a, sa)
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, sa, la = step(a, sa, batch)
            b, sb, lb = step(b, sb, batch)
        finally:
            torch.use_deterministic_algorithms(det, warn_only=warn)
    stepped = same_bits(train_state(a, sa), train_state(b, sb)) and \
        torch.equal(la["loss"], lb["loss"])
    # the same step twice from the saved state, atomics on
    c = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    sc = opt.init(c)
    for leaf, t in zip([p for _, p in named_leaves(c)] + [sc.step]
                       + list(sc.m.values()) + list(sc.v.values()), saved):
        with torch.no_grad():
            leaf.copy_(t)
    c, sc, _ = step(c, sc, batch)
    atomics_equal = same_bits(train_state(a, sa), train_state(c, sc))
    print(f"[train] checkpoint at {cfg.name} on the card (cut: the "
          f"full-width file would be ~5 GB): save {t_save * 1e3:.1f} ms, "
          f"step {mf['step']}; restored state equal bits: {restored}; one "
          f"more step from the restored and from the unsaved state "
          f"(deterministic mode) equal bits: {stepped}; the same step "
          f"with index_add_'s atomics equal bits: {atomics_equal}")
    if not restored or not stepped:
        raise RuntimeError(f"checkpoint round trip on the card: restored "
                           f"{restored}, stepped {stepped}")


def train_phase(dev, tmp) -> dict:
    """xDeepFM training on the card (phase 3j; see the module docstring).
    Returns the launches of the path, the step's kernel device times at
    the train batch, {kernel: ms}, under "train_kernel_ms", and the
    gradient kernels' errors against their plain versions at B = 512 on
    the model's inputs, {kernel: (abs, relative)}, under
    "grad_errors"."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.device import synchronize
    from repro_torch.kernels import cin as kcin
    from repro_torch.launch.specs import RECSYS_SHAPE_DEFS, \
        recsys_model_flops
    from repro_torch.models import recsys
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import (TrainerConfig, fit, to_device,
                                           trainable)

    kernels = {k: getattr(kcin, k) for k in ("cin_layer",) + GRAD_KERNELS}
    cfg = xdeepfm.full()
    B = RECSYS_SHAPE_DEFS["train_batch"]["batch"]
    steps = TRAIN_STEPS
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = recsys.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    synchronize(dev)
    t_init = time.perf_counter() - t0
    stream = RecsysStream(cfg.n_fields, cfg.vocab_per_field, B,
                          cfg.multi_hot_fields, cfg.bag_size)
    t0 = time.perf_counter()
    batches = [stream.batch_at(s) for s in range(steps + 1)]
    t_data = time.perf_counter() - t0
    opt = AdamW(lr=cosine_schedule(3e-3, 10, steps))   # the CLI's lr
    clock = []     # (start, end) CUDA events of each step

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def batch_at(s):
        clock.append([mark(), None])
        return batches[s]

    def log(line):
        clock[-1][1] = mark()
        print(line)

    base = torch.cuda.memory_allocated() / 2**30
    for kern in kernels.values():
        kern.launches = 0
    model, state, history = fit(
        lambda p, b: recsys.loss_fn(cfg, p, b), model, batch_at, opt,
        TrainerConfig(steps=steps, log_every=1), log=log)
    synchronize(dev)
    launches = {("cin" if k == "cin_layer" else k): kern.launches
                for k, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in clock]
    losses = [l for _, l in history]
    flops = recsys_model_flops(cfg, B, train=True)
    print(f"[train] {cfg.name}: {cfg.param_count():,} parameters, init "
          f"{t_init:.2f}s; {steps} fit steps of B={B:,} RecsysStream "
          f"batches with mh_ids (made on the host in {t_data:.2f}s, before "
          f"the steps); losses {losses}; step ms (CUDA events, batch copy "
          f"to loss read) {[round(t, 3) for t in step_ms]}, p50 "
          f"{float(np.percentile(step_ms, 50)):.3f} max "
          f"{max(step_ms):.3f}; {flops / 1e12:.3f} TFLOP a step (CIN + "
          f"MLP x3), {flops / np.percentile(step_ms, 50) / 1e9:.2f} "
          f"TFLOP/s at p50; device peak {peak:.2f} GiB ({base:.2f} GiB "
          f"allocated before the steps, the model included); launches "
          f"{launches}")
    if len(losses) != steps or not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"training losses not finite: {losses}")

    # ---- one more step by parts, traced: where the step's time goes --
    def traced_step():
        b = to_device(batches[steps], model)
        leaves = trainable(model)
        e = [mark()]
        loss = recsys.loss_fn(cfg, model, b)
        e.append(mark())
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        e.append(mark())
        opt.update({n: g for (n, _), g in zip(leaves, grads)}, state,
                   model)
        e.append(mark())
        synchronize(dev)
        return [a.elapsed_time(b) for a, b in zip(e, e[1:])]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        parts = traced_step()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False)]
    buckets = {"cin": 0.0, "index": 0.0, "fill": 0.0, "gemm": 0.0,
               "other": 0.0}
    by_kernel = {}
    mode_calls = {}
    for r in rows:
        us = r.self_device_time_total
        low = r.key.lower()
        if "cin_" in low:
            key = "cin"
            mode = cin_mode(r.key)
            by_kernel[mode] = by_kernel.get(mode, 0.0) + us / 1e3
            mode_calls[mode] = mode_calls.get(mode, 0) + r.count
        elif "index" in low or "scatter" in low or "gather" in low:
            key = "index"
        elif "fill" in low:
            key = "fill"
        elif any(s in low for s in ("gemm", "sm90", "cutlass", "xmma")):
            key = "gemm"
        else:
            key = "other"
        buckets[key] += us / 1e3
    total = sum(buckets.values())
    print(f"[train] one more step by parts (CUDA events): forward + "
          f"loss {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, AdamW "
          f"{parts[2]:.3f} ms ({100 * parts[2] / sum(parts):.1f}% of "
          f"{sum(parts):.3f}); device time by kernel family "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in buckets.items())
          + f"; cin kernels by mode {by_kernel}, launches {mode_calls} "
            f"(layer: forward and dxk; dx0: every layer's dx0, the GEMM "
            f"over g with xk in its epilogue; wgrad: dW; gt: dW's g "
            f"pre-pass; g2: dx0's g pre-pass; split: the W splits of the "
            f"layer and of dx0; sum: the depth chunks' sum; stream: the "
            f"layer with x0 read from device memory, which training must "
            f"not run)")
    # each pre-pass reads g once and writes its two TF32 parts
    g_bytes = sum(4 * (1 + 2) * B * W.shape[0] * cfg.embed_dim
                  for W in model.recsys.cin_w)
    for mode, what in (("gt", "dW's g pre-pass (cin_split_gt)"),
                       ("g2", "dx0's g pre-pass (cin_split_g)")):
        ms = by_kernel.get(mode, 0.0)
        print(f"[train] {what}: {ms:.3f} ms for {mode_calls.get(mode, 0)} "
              f"launches, {g_bytes / 1e9:.3f} GB moved "
              f"({g_bytes / 1e6 / max(ms, 1e-9):.1f} GB/s); each launch's "
              f"copy lives for its gradient call")
    print(f"[train] the traced step's device peak {step_peak:.2f} GiB")
    for line in prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=12).splitlines():
        print(f"[train] {line}")
    if "stream" in by_kernel or not all(k in by_kernel for k in
                                        ("layer", "dx0", "wgrad", "gt",
                                         "g2")):
        raise RuntimeError(f"the train step did not run the CIN gradient's "
                           f"modes as designed: {by_kernel}")
    del state, batches

    # ---- the gradient kernels vs plain: B = 512 and a train slice ----
    serve_b = stream.batch_at(0)
    small = {k: v[:RECSYS_SHAPE_DEFS["serve_p99"]["batch"]]
             for k, v in serve_b.items()}
    errors = grad_checks(f"B={len(small['ids'])}",
                         grad_cases(model, small, dev, 2))
    cut = {k: v[:N_SLICE] for k, v in stream.batch_at(steps + 1).items()}
    cases = grad_cases(model, cut, dev, 3)
    del cases["unit"]
    grad_checks(f"a {N_SLICE:,}-row slice of a train batch", cases)
    del cases, model
    torch.cuda.empty_cache()
    checkpoint_check(dev, tmp)
    print(f"[train] phase {time.perf_counter() - t_phase:.1f}s; card "
          f"{card_line()}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a cin kernel did not launch on the training "
                           f"path: {launches}")
    return {**launches, "train_kernel_ms": by_kernel,
            "grad_errors": errors}


def gnn_steps(cfg, batch, dev, steps: tuple, n: int, m: int,
              d_feat: int, label: str) -> dict:
    """``steps[0]`` warm-up and ``steps[1]`` timed ``gnn_train_step``s of
    ``cfg`` at full width on ``batch`` (already on the card) with
    ``AdamW(lr=1e-3)``, then ``gnn_infer_step`` five times: each step
    timed by CUDA events from its call to its loss's read. Prints the
    losses, the step p50 and max, TFLOP/s at p50 (``gnn_model_flops``
    at n, m, d_feat) and the device peak; every loss must be finite,
    and the parameters and the outputs must lie on the card."""
    import numpy as np
    import torch

    from repro_torch.launch.specs import gnn_model_flops
    from repro_torch.models import gnn as G
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import gnn_infer_step, gnn_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = gnn_train_step(cfg, opt)
    losses, step_ms = [], []
    for k in range(sum(steps)):
        def one():
            nonlocal params, state
            params, state, met = step(params, state, batch)
            return float(met["loss"])
        loss, t = events_ms(one)
        losses.append(loss)
        if k >= steps[0]:
            step_ms.append(t)
    infer = gnn_infer_step(cfg)
    out = infer(params, batch)
    infer_ms = []
    for _ in range(5):
        out, t = events_ms(lambda: infer(params, batch))
        infer_ms.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    p50 = float(np.percentile(step_ms, 50))
    flops = gnn_model_flops(cfg, n, m, d_feat)
    on_card = all(p.device.type == "cuda" for p in params.parameters()) \
        and out.device.type == "cuda"
    n_par = sum(p.numel() for p in params.parameters())
    print(f"[gnn] {label} {cfg.name} ({n_par:,} parameters, out "
          f"{tuple(out.shape)}): losses {losses}; step ms (CUDA events, "
          f"call to loss read) {[round(t, 3) for t in step_ms]}, p50 "
          f"{p50:.3f} max {max(step_ms):.3f}; {flops / 1e12:.4f} TFLOP a "
          f"step (gnn_model_flops), {flops / p50 / 1e9:.3f} TFLOP/s at "
          f"p50; infer p50 {float(np.percentile(infer_ms, 50)):.3f} ms; "
          f"device peak {peak:.3f} GiB ({base:.3f} GiB allocated before "
          f"the model, the batch and earlier phases' state); on the card "
          f"{on_card}")
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"{label} {cfg.name}: a loss is not finite: "
                           f"{losses}")
    if not on_card:
        raise RuntimeError(f"{label} {cfg.name}: parameters or outputs "
                           "off the card")
    return {"p50": p50, "peak": peak}


def gnn_checkpoint_check(dev, tmp) -> None:
    """A checkpoint at ``gcn-cora`` ``smoke()`` on the card: two steps on
    the CLI's graph, ``save``, ``restore`` into a model drawn from
    another seed (equal bits), then one more step from the unsaved
    state and one from the restored state, which must give equal bits.
    ``index_add`` and the gathers' gradients add with atomics on the
    card, so both steps run under ``torch.use_deterministic_algorithms``
    (as phase 3j); the ops that warn there are printed."""
    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.launch.train import gnn_graph_batch
    from repro_torch.models import gnn as G
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.steps import gnn_train_step
    from repro_torch.train.trainer import to_device

    cfg = cfg_base.get("gcn-cora").smoke()
    opt = AdamW(lr=1e-3)
    step = gnn_train_step(cfg, opt)
    a = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = to_device(gnn_graph_batch(cfg), a)
    sa = opt.init(a)
    for _ in range(2):
        a, sa, _ = step(a, sa, batch)
    ckpt = str(Path(tmp) / "gnn_ckpt")
    checkpoint.save(ckpt, 1, a, sa, extra={"cursor": 2})
    b = G.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    sb = opt.init(b)
    b, sb, mf = checkpoint.restore(ckpt, checkpoint.latest_step(ckpt), b, sb)
    restored = same_bits(train_state(a, sa), train_state(b, sb))
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, sa, la = step(a, sa, batch)
            b, sb, lb = step(b, sb, batch)
        finally:
            torch.use_deterministic_algorithms(det, warn_only=warn)
    stepped = same_bits(train_state(a, sa), train_state(b, sb)) and \
        torch.equal(la["loss"], lb["loss"])
    warned = sorted({str(w.message).split(".")[0][:80] for w in caught})
    print(f"[gnn] checkpoint at {cfg.name} on the card: step {mf['step']}; "
          f"restored state equal bits: {restored}; one more step from the "
          f"restored and from the unsaved state (deterministic mode) equal "
          f"bits: {stepped}; ops that warned there: {warned}")
    if not restored or not stepped:
        raise RuntimeError(f"GNN checkpoint round trip on the card: "
                           f"restored {restored}, stepped {stepped}")


def gnn_phase(g, dev, tmp) -> dict:
    """Phase 3k, the GNN stack on the card (see the module docstring).
    GraphCast is left out of minibatch_lg: at 16 layers x 512 over
    339,968 nodes (grid and mesh) its saved activations come to roughly
    60-70 GB. Returns the launches of the example's path (its ``build_index``
    and ``run_join``), which phase 3k zeroes before and reads after."""
    import dataclasses
    import importlib.util
    import os

    import numpy as np
    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import gnn_batch
    from repro_torch.device import synchronize
    from repro_torch.graph import generators
    from repro_torch.graph.sampler import sample_subgraph
    from repro_torch.join import KnnGraph
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.launch.specs import GNN_SHAPE_DEFS

    t_phase = time.perf_counter()

    def full(arch, d_feat):
        return dataclasses.replace(cfg_base.get(arch).full(), d_in=d_feat)

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    # ---- (a) full_graph_sm: the four configs at full width -------------
    d = GNN_SHAPE_DEFS["full_graph_sm"]
    gs = generators.barabasi_albert(d["n"], 2, seed=0, directed=False)
    print(f"[gnn] full_graph_sm: barabasi_albert({d['n']}, 2): m={gs.m} "
          f"({100 * (gs.m / d['m'] - 1):+.2f}% of the cell's {d['m']:,})")
    for arch in GNN_ARCHS:
        cfg = full(arch, d["d_feat"])
        if cfg.kind != "graphcast":
            batch = gnn_batch(gs, d["d_feat"], cfg.n_classes)
            gnn_steps(cfg, on_card(batch), dev, GNN_STEPS, gs.n, gs.m,
                      d["d_feat"], "full_graph_sm")
            continue
        # _gnn_cell's layout: n grid nodes, then the n mesh nodes that
        # carry the cell's graph; 2n g2m and 2n m2g edges, seeded. The
        # mesh is a 52 x 52 grid (degree <= 4, as a weather mesh's), not
        # the BA graph: through the BA graph's hubs (in-degree 166) the
        # 16 residual sum layers overflow float32 at random init (loss
        # inf at step 0), in the reference's arithmetic as in the port's
        gm = generators.grid2d(*MESH_GRID)
        n = gm.n
        print(f"[gnn] full_graph_sm graphcast mesh: grid2d{MESH_GRID}: "
              f"n={n} m={gm.m} ({100 * (gm.m / d['m'] - 1):+.2f}% of the "
              f"cell's {d['m']:,}), max in-degree {int(gm.in_deg.max())}")
        rng = np.random.default_rng(0)
        batch = {
            "feats": rng.normal(size=(2 * n, d["d_feat"])).astype(
                np.float32),
            "edge_src": (gm.edge_src + n).astype(np.int32),
            "edge_dst": (gm.edge_dst + n).astype(np.int32),
            "edge_mask": np.ones(gm.m, np.float32),
            "node_mask": np.ones(2 * n, np.float32),
            "n_grid": np.int32(n),
            "g2m_src": rng.integers(0, n, 2 * n).astype(np.int32),
            "g2m_dst": rng.integers(n, 2 * n, 2 * n).astype(np.int32),
            "g2m_mask": np.ones(2 * n, np.float32),
            "m2g_src": rng.integers(n, 2 * n, 2 * n).astype(np.int32),
            "m2g_dst": rng.integers(0, n, 2 * n).astype(np.int32),
            "m2g_mask": np.ones(2 * n, np.float32),
            "targets": rng.normal(size=(2 * n, cfg.n_vars)).astype(
                np.float32),
        }
        gnn_steps(cfg, on_card(batch), dev, GNN_STEPS, n, gm.m,
                  d["d_feat"], "full_graph_sm")

    # ---- (b) minibatch_lg: the SimRank-weighted sampler on Enron -------
    d = GNN_SHAPE_DEFS["minibatch_lg"]
    knn = KnnGraph.load(os.path.join(tmp, "enron.knn.npz"))
    rng = np.random.default_rng(11)
    seeds = rng.choice(g.n, LG_SEEDS, replace=False)
    t0 = time.perf_counter()
    sub = sample_subgraph(g, seeds, LG_FANOUT, rng, d["n"], d["m"], knn=knn)
    t_sample = time.perf_counter() - t0
    N, M = int(sub.node_mask.sum()), int(sub.edge_mask.sum())
    print(f"[gnn] minibatch_lg: sample_subgraph(Enron, {LG_SEEDS} seeds, "
          f"fanout {LG_FANOUT}, knn= phase 3f's all-source KnnGraph file, "
          f"{knn.nnz:,} scores) {t_sample:.3f} s on the host: N={N:,} "
          f"M={M:,} in n_pad={d['n']:,} m_pad={d['m']:,}")
    gen = torch.Generator(device=dev).manual_seed(12)
    for arch in ("gcn-cora", "gat-cora", "pna"):
        cfg = full(arch, d["d_feat"])
        batch = on_card({"edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
                         "edge_mask": sub.edge_mask,
                         "node_mask": sub.node_mask})
        batch["feats"] = torch.randn((d["n"], d["d_feat"]), generator=gen,
                                     device=dev)
        batch["labels"] = torch.randint(0, cfg.n_classes, (d["n"],),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
        gnn_steps(cfg, batch, dev, LG_STEPS, d["n"], d["m"], d["d_feat"],
                  "minibatch_lg")
        del batch
    del knn, sub

    gnn_checkpoint_check(dev, tmp)

    # ---- the SimRank example on the card: build_index, run_join, fit ---
    spec = importlib.util.spec_from_file_location(
        "torch_train_gnn_simrank",
        ROOT / "examples" / "torch_train_gnn_simrank.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    hp_join.launches = horner_push_rows.launches = spmm.launches = 0
    horner_push_rows.steps = 0
    t0 = time.perf_counter()
    example.main(["--device", "cuda"])
    synchronize(dev)
    launches = {"hp_join": hp_join.launches,
                "horner_push": horner_push_rows.launches,
                "spmm": spmm.launches,
                "horner_push_steps": horner_push_rows.steps}
    print(f"[gnn] examples/torch_train_gnn_simrank.py on the card: "
          f"{time.perf_counter() - t0:.2f} s, launches {launches}")
    if launches["spmm"] <= 0 or launches["horner_push"] <= 0:
        raise RuntimeError(f"the SimRank GNN example did not launch spmm "
                           f"and horner_push: {launches}")
    print(f"[gnn] phase {time.perf_counter() - t_phase:.1f}s; card "
          f"{card_line()}")
    return launches


def free_bytes() -> int:
    """Bytes a new allocation can take: the card's free memory plus what
    the caching allocator holds unused."""
    import torch
    free, _ = torch.cuda.mem_get_info()
    return free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()


def pow2_at_most(x: float, cap: int) -> int:
    b = 1
    while b * 2 <= min(x, cap):
        b *= 2
    return b


def lm_stats(label: str, ms: list, tokens: int, flops: float) -> str:
    """'p50 .. max ..; tokens/s; TFLOP/s (lm_model_flops); peak' of a
    timed LM call, its ``tokens`` and ``flops`` a call."""
    import numpy as np
    import torch
    p50 = float(np.percentile(ms, 50))
    return (f"{label}: ms (CUDA events) {[round(t, 3) for t in ms]}, p50 "
            f"{p50:.3f} max {max(ms):.3f}; {tokens * 1e3 / p50:,.1f} "
            f"tokens/s; {flops / 1e12:.3f} TFLOP a call (lm_model_flops), "
            f"{flops / p50 / 1e9:.3f} TFLOP/s at p50; device peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def lm_train(cfg, dev) -> None:
    """train_4k at full width and B = LM_TRAIN_BATCH: one warm-up and
    the timed ``lm_train_step``s on ``TokenStream`` batches, every loss
    finite. A batch that does not fit the card raises, naming the
    memory held before the steps."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.specs import LM_SHAPE_DEFS, lm_model_flops
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import lm_train_step

    d = LM_SHAPE_DEFS["train_4k"]
    B, S = LM_TRAIN_BATCH, d["seq"]
    params = lm_params(cfg, dev)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = lm_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab, B, S, seed=0)
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for k in range(sum(LM_TRAIN_STEPS)):
        batch = stream.batch_at(k)

        def one():
            nonlocal params, state
            params, state, m = step(params, state, batch)
            return float(m["loss"])
        try:
            loss, t = events_ms(one)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"{cfg.name} train_4k at B = {B} does not fit the card "
                f"({held:.3f} GiB held before the steps)") from e
        losses.append(loss)
        if k >= LM_TRAIN_STEPS[0]:
            ms.append(t)
    on_card = all(p.device.type == dev.type for p in params.parameters())
    print(f"[lm] {cfg.name} " + lm_stats(
        f"train_4k B = {B} of the cell's {d['batch']} x {S} ({held:.3f} "
        f"GiB held before the steps), {LM_TRAIN_STEPS[1]} timed steps "
        f"after {LM_TRAIN_STEPS[0]}, losses "
        f"{[round(l, 4) for l in losses]}, step", ms, B * S,
        lm_model_flops(cfg, "train", B, S))
          + f"; parameters on the card {on_card}")
    if not all(math.isfinite(l) for l in losses) or not on_card:
        raise RuntimeError(f"{cfg.name} train_4k: losses {losses}, on the "
                           f"card {on_card}")
    del params, state, step, opt
    torch.cuda.empty_cache()


def lm_prefill(cfg, params, B: int, S: int, label: str):
    """LM_PREFILL_STEPS of ``lm_prefill_step`` over (B, S) ``TokenStream``
    tokens; returns the last call's cache (exactly S slots)."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.specs import lm_model_flops
    from repro_torch.train.steps import lm_prefill_step

    step = lm_prefill_step(cfg)
    tokens = torch.as_tensor(TokenStream(cfg.vocab, B, S, seed=2).batch_at(
        0)["tokens"], device=params.embed.device)
    torch.cuda.reset_peak_memory_stats()
    ms, out = [], None
    for k in range(sum(LM_PREFILL_STEPS)):
        out = None     # one cache at a time
        out, t = events_ms(lambda: step(params, {"tokens": tokens}))
        if k >= LM_PREFILL_STEPS[0]:
            ms.append(t)
    finite = bool(torch.isfinite(out["logits"]).all())
    print(f"[lm] {cfg.name} " + lm_stats(
        f"{label} prefill B = {B} x {S}, call", ms, B * S,
        lm_model_flops(cfg, "prefill", B, S)) + f"; logits finite {finite}")
    if not finite:
        raise RuntimeError(f"{cfg.name} {label}: prefill logits not finite")
    return out["cache"]


def lm_decode(cfg, params, cache, steps: tuple, seq: int, label: str,
              profile: bool = False):
    """``steps`` (warm-up, timed) ``lm_decode_step`` calls from ``cache``
    (written in place), each token the previous logits' argmax; the
    TFLOP/s by ``lm_model_flops`` at ``seq``; with ``profile``, one more
    step under ``trace`` (the cache needs a slot for it)."""
    import torch

    from repro_torch.launch.specs import lm_model_flops
    from repro_torch.train.steps import lm_decode_step

    step = lm_decode_step(cfg)
    B = cache["k"].shape[1]
    token = torch.arange(B, device=params.embed.device) % cfg.vocab
    start = cache["len"]
    torch.cuda.reset_peak_memory_stats()
    ms, finite = [], True
    for k in range(sum(steps)):
        out, t = events_ms(lambda: step(params, cache, {"token": token}))
        cache = out["cache"]
        token = out["logits"].argmax(-1)
        finite = finite and bool(torch.isfinite(out["logits"]).all())
        if k >= steps[0]:
            ms.append(t)
    if profile:
        trace(f"lm {cfg.name} {label} decode step",
              lambda: step(params, cache, {"token": token}))
    print(f"[lm] {cfg.name} " + lm_stats(
        f"{label} decode B = {B}, cache {cache['k'].shape[2]:,} slots "
        f"from len {start:,}, {steps[1]} timed token steps after "
        f"{steps[0]}, token step", ms, B,
        lm_model_flops(cfg, "decode", B, seq)) + f"; logits finite {finite}")
    if not finite or cache["len"] != start + sum(steps):
        raise RuntimeError(f"{cfg.name} {label}: decode logits finite "
                           f"{finite}, len {cache['len']}")


def lm_params(cfg, dev):
    """Seeded ``init_params`` on ``dev`` with wq scaled by sqrt(H /
    d_model) and wk, wv by sqrt(K / d_model), in place: fan_in d_model
    where the reference's ``dense_init`` takes the head count, so that
    the random-init model is well-conditioned and decode can be held to
    forward (tests/test_torch_lm.py's ``_conditioned``)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            getattr(params.blocks, name).mul_(
                float(np.float32(np.sqrt(heads / cfg.d_model))))
    return params


def decode_and_forward(cfg, params, toks, nxt=None):
    """(decode logits of ``nxt`` after a prefill over ``toks`` through the
    cache padded by 8, the last logits of ``forward`` over ``toks`` plus
    ``nxt``, ``nxt``), float32 logits; ``nxt`` defaults to the prefill's
    argmax."""
    from repro_torch.models import transformer as T
    logits, cache = T.prefill(cfg, params, toks)
    if nxt is None:
        nxt = logits.argmax(-1)
    dec, _ = T.decode_step(cfg, params,
                           T.pad_cache(cache, toks.shape[1] + 8), nxt)
    del cache
    return dec, forward_logits(cfg, params, toks, nxt), nxt


def forward_logits(cfg, params, toks, nxt):
    import torch

    from repro_torch.models import transformer as T
    with torch.no_grad():
        x, _ = T.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1))
        return (x[:, -1] @ params.embed.to(cfg.dtype).T).to(torch.float32)


def lm_agreement(cfg, params, prompt: int) -> None:
    """Decoding one token through the padded cache against ``forward``
    over the prompt plus that token (B = 1, ``TokenStream`` prompt, all
    the layers, ``lm_params``' conditioned weights).

    float32: within TOL_DECODE of max |logit| (the two paths differ in
    reduction order only). bf16: within LM_BF16_DECODE bf16 ulps
    (BF16_ULP of max |logit| each): the two bf16 paths round at
    different points (decode forms its scores in bf16 over the cache,
    the forward in float32 through flash attention), each some ulps
    from the float32 result; both distances from float32 are printed.

    An MoE config is checked at capacity_factor E / k, where no
    assignment is dropped: at its own factor the forward over the whole
    prompt drops the assignments past an expert's capacity (the last
    token's first, as the reference's routing does), while a one-token
    decode step drops none, so the two differ by design; that difference
    is printed beside the check."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import TokenStream

    dev = params.embed.device
    toks = torch.as_tensor(TokenStream(cfg.vocab, 1, prompt, seed=3)
                           .batch_at(0)["tokens"], device=dev)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    notes, failed = [], []
    if cfg.is_moe:
        dec, fwd, _ = decode_and_forward(c32, params, toks)
        notes.append(f"at its own capacity_factor {cfg.capacity_factor} "
                     f"float32 {rel_err(dec, fwd):.3g}")
        free_cf = cfg.moe_experts / cfg.moe_top_k
        cfg = dataclasses.replace(cfg, capacity_factor=free_cf)
        c32 = dataclasses.replace(c32, capacity_factor=free_cf)
        notes.append(f"checked at capacity_factor {free_cf:g}")
    d32, f32, nxt = decode_and_forward(c32, params, toks)
    err = rel_err(d32, f32)
    notes.append(f"float32 {err:.3g} of max |logit| (limit {TOL_DECODE}), "
                 f"argmax equal {bool(torch.equal(d32.argmax(-1), f32.argmax(-1)))}")
    if not err <= TOL_DECODE:
        failed.append("float32")
    d16, f16, _ = decode_and_forward(cfg, params, toks, nxt)
    err = rel_err(d16, f16) / BF16_ULP
    notes.append(f"{str(cfg.dtype).split('.')[-1]} {err:.3g} bf16 ulps "
                 f"(limit {LM_BF16_DECODE}); from the float32 forward: "
                 f"decode {rel_err(d16, f32) / BF16_ULP:.3g}, forward "
                 f"{rel_err(f16, f32) / BF16_ULP:.3g}")
    if not err <= LM_BF16_DECODE:
        failed.append("bf16")
    print(f"[lm] {cfg.name} decode vs forward over {prompt} + 1 tokens, "
          f"all {cfg.n_layers} layers: " + "; ".join(notes))
    if failed:
        raise RuntimeError(f"{cfg.name}: decode disagrees with forward: "
                           f"{failed}")


def cache_of(cache, B: int, slots: int) -> dict:
    """A (L, B, slots, K, dh) cache whose rows repeat ``cache``'s rows
    (B a multiple of its batch), its len leaving room for the
    LM_DECODE_STEPS and one traced step."""
    import torch
    k0 = cache["k"]
    L, b0, S0 = k0.shape[:3]
    n = min(S0, slots)
    out = {"len": slots - sum(LM_DECODE_STEPS) - 1}
    for name in ("k", "v"):
        t = torch.empty((L, B, slots) + tuple(k0.shape[3:]), dtype=k0.dtype,
                        device=k0.device)
        t.view(L, B // b0, b0, slots, *k0.shape[3:])[:, :, :, :n] = \
            cache[name][:, None, :, :n]
        if n < slots:
            t[:, :, n:] = 0
        out[name] = t
    return out


def ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of max |ref| (BF16_ULP each)."""
    return rel_err(got, ref) / BF16_ULP


def assembled(st, pieces, dev):
    """The whole of a placed leaf from {position: that position's piece}
    (a partitioned step's gradients), float32 on ``dev``."""
    import torch
    out = torch.empty(st.shape, dtype=torch.float32, device=dev)
    for p, sl in st.sharding.devices_indices_map(st.shape).items():
        out[sl] = pieces[p]
    return out


def lm_cell_peak(arch: str, mesh, batch: int) -> float:
    """The dry run's busiest-device peak (GiB) of ``arch``'s train_4k cell
    at ``batch`` rows on ``mesh`` (``launch/dryrun.run_cell``: fake
    tensors, nothing allocated)."""
    from repro_torch.launch import dryrun, specs

    saved = specs.LM_SHAPE_DEFS
    specs.LM_SHAPE_DEFS = dict(saved, train_4k=dict(saved["train_4k"],
                                                    batch=batch))
    try:
        rec = dryrun.run_cell(arch, "train_4k", verbose=False, mesh=mesh)
    finally:
        specs.LM_SHAPE_DEFS = saved
    return rec["bytes_per_device"]["peak_est"] / 2**30


def lm_mesh_train(cfg, params, mesh, dev, bad: list,
                  predict: str | None = None,
                  steps: tuple = LM_MESH_TRAIN_STEPS,
                  f32: bool = True) -> None:
    """train_4k on the mesh at B = LM_MESH_TRAIN_B, S = LM_MESH_SEQ: the
    partitioned loss and each leaf's max |grad| (of the gradient
    assembled from the pieces') against the unpartitioned ``lm_loss`` on
    the card; each gradient's largest entrywise distance, to that step's
    and (``f32``) to the unpartitioned float32 step's, printed beside
    them; then
    ``steps`` (warm-up, timed) partitioned ``lm_train_step_sharded`` s
    on a copy, their peak (the arguments they were given and the steps'
    temporaries) beside the dry run's prediction for arch ``predict``'s
    train_4k cell at that batch on the mesh when given."""
    import copy
    import dataclasses

    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import lm_model_flops
    from repro_torch.models import transformer as T
    from repro_torch.models import transformer_sharded as TS
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import lm_train_step_sharded
    from repro_torch.train.trainer import value_and_grad

    B, S = LM_MESH_TRAIN_B, LM_MESH_SEQ
    b = TokenStream(cfg.vocab, B, S, seed=5).batch_at(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def whole(c):
        return value_and_grad(
            lambda p, x: T.lm_loss(c, p, x["tokens"], x["targets"]),
            params, batch)
    g32 = whole(dataclasses.replace(cfg, dtype=torch.float32))[1] \
        if f32 else None
    ref_loss, ref_g = whole(cfg)
    with sh.use_mesh_rules(mesh):
        leaves = TS.place_params(params)
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), ms = events_ms(lambda: TS.value_and_grad(
            cfg, leaves, batch["tokens"], batch["targets"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
    e_loss = ulps(loss, ref_loss)
    e_max, e_elem = {}, {}
    for n, st in leaves.items():
        got = assembled(st, grads[n], dev)
        e_max[n] = ulps(got.abs().max(), ref_g[n].abs().max())
        e_elem[n] = (round(ulps(got, ref_g[n]), 2),
                     *((round(ulps(got, g32[n]), 2),
                        round(ulps(ref_g[n], g32[n]), 2)) if f32 else ()))
    worst = max((v, n) for n, v in e_max.items())
    del grads, ref_g, g32, leaves
    pred = None if predict is None else lm_cell_peak(predict, mesh, B)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    copy_ = copy.deepcopy(params)
    opt = AdamW(lr=1e-3)
    step = lm_train_step_sharded(cfg, opt)
    with sh.use_mesh_rules(mesh):
        leaves = TS.place_params(copy_)
        state = placed_state(opt, copy_, mesh)
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for k in range(sum(steps)):
            (leaves, state, m), t = events_ms(
                lambda: step(leaves, state, batch))
            losses.append(float(m["loss"]))
            if k >= steps[0]:
                times.append(t)
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        cell_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"[lm-mesh] {cfg.name} train_4k B = {B} x {S} on {LM_MESH}: loss "
          f"{float(loss):.5f} vs unpartitioned {float(ref_loss):.5f} "
          f"({e_loss:.3g} bf16 ulps, limit {LM_MESH_OUT}); each leaf's "
          f"max |g| within {worst[0]:.3g} ulps ({worst[1]}, limit "
          f"{LM_MESH_GRAD}); entrywise, in ulps of max |g|, (partitioned "
          f"vs unpartitioned"
          + (", partitioned vs float32, unpartitioned vs float32"
             if f32 else "") + f") a leaf {e_elem}; value and grad "
          f"{ms:.3f} ms, device peak {peak:.3f} GiB; "
          + lm_stats(f"{steps[1]} timed steps after "
                     f"{steps[0]}, losses "
                     f"{[round(l, 4) for l in losses]}, step", times,
                     B * S, lm_model_flops(cfg, "train", B, S))
          + f" (steps' peak {step_peak:.3f} GiB; the cell's, its "
          f"arguments and the steps' temporaries, {cell_peak:.3f} GiB"
          + ("" if pred is None else f", the dry run's prediction on "
             f"{LM_MESH} {pred:.3f} GiB") + "); port kernels launched "
          f"none (the LM path has none)")
    if not e_loss <= LM_MESH_OUT or not worst[0] <= LM_MESH_GRAD:
        bad.append(f"{cfg.name} train: loss {e_loss:.3g} ulps, max |g| "
                   f"{worst[0]:.3g} ulps ({worst[1]})")
    del leaves, state, copy_


def lm_mesh_serve(cfg, params, mesh, dev, label: str, bad: list,
                  census: bool = False) -> None:
    """Prefill at B = LM_MESH_SERVE_B, S = LM_MESH_SEQ and LM_MESH_DECODE
    decode steps on the mesh, against the unpartitioned prefill and
    decode on the card: the logits, the cache gathered from its pieces
    after the prefill and after the decode steps. With ``census``, the
    profiler's kernels and host launches of one partitioned prefill and
    one decode step."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import lm_rules
    from repro_torch.models import transformer as T
    from repro_torch.models import transformer_sharded as TS

    B, S = LM_MESH_SERVE_B, LM_MESH_SEQ
    tokens = torch.as_tensor(TokenStream(cfg.vocab, B, S, seed=6).batch_at(
        0)["tokens"], device=dev)
    ref_logits, ref_cache = T.prefill(cfg, params, tokens)
    leaves = TS.place_params(params, mesh)
    with sh.use_mesh_rules(mesh, lm_rules("prefill", B)):
        torch.cuda.reset_peak_memory_stats()
        (logits, cache), p_ms = events_ms(
            lambda: TS.prefill(cfg, leaves, tokens))
        p_peak = torch.cuda.max_memory_allocated() / 2**30
        p_census = launch_census(lambda: TS.prefill(cfg, leaves, tokens),
                                 1) if census else None
    errs = {"prefill logits": ulps(logits.gather(dev), ref_logits)}
    k0, v0 = cache["k"].gather(dev), cache["v"].gather(dev)
    errs["prefill cache k"] = ulps(k0, ref_cache["k"])
    errs["prefill cache v"] = ulps(v0, ref_cache["v"])
    del cache, logits
    slots = S + LM_MESH_DECODE + 1
    ref = T.pad_cache(ref_cache, slots)
    mine = T.pad_cache({"k": k0, "v": v0, "len": S}, slots)
    del ref_cache, k0, v0
    token = ref_logits.argmax(-1)
    d_ms = []
    with sh.use_mesh_rules(mesh, lm_rules("decode", B)):
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        spec = sh.spec_for(tuple(mine["k"].shape), names, mesh)
        placed = {"k": sh.place(mine["k"], spec, mesh),
                  "v": sh.place(mine["v"], spec, mesh), "len": S}
        torch.cuda.reset_peak_memory_stats()
        for i in range(LM_MESH_DECODE):
            rl, ref = T.decode_step(cfg, params, ref, token)
            (ml, placed), t = events_ms(
                lambda: TS.decode_step(cfg, leaves, placed, token))
            d_ms.append(t)
            errs[f"decode {i} logits"] = ulps(ml.gather(dev), rl)
            token = rl.argmax(-1)
        d_peak = torch.cuda.max_memory_allocated() / 2**30
        errs["decode cache k"] = ulps(placed["k"].gather(dev), ref["k"])
        errs["decode cache v"] = ulps(placed["v"].gather(dev), ref["v"])
        # the census's steps write the cache's spare slot
        d_census = launch_census(
            lambda: TS.decode_step(cfg, leaves, placed, token), 1) \
            if census else None
    worst = max(errs.values())
    note = ""
    if census:
        note = (f"; one partitioned prefill {p_census['kernels']:.0f} "
                f"kernels, {p_census['host']:.0f} host launches, device "
                f"busy {p_census['busy_pct']:.1f} %; one decode step "
                f"{d_census['kernels']:.0f} kernels, "
                f"{d_census['host']:.0f} host launches, busy "
                f"{d_census['busy_pct']:.1f} %")
    print(f"[lm-mesh] {cfg.name} {label} B = {B} on {LM_MESH}: prefill "
          f"{S} tokens {p_ms:.3f} ms (device peak {p_peak:.3f} GiB), "
          f"{LM_MESH_DECODE} decode steps ms {[round(t, 3) for t in d_ms]} "
          f"(peak {d_peak:.3f} GiB); against the unpartitioned steps in "
          f"bf16 ulps of max |ref| (limit {LM_MESH_OUT}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + "; port kernels launched none (the LM path has none)" + note)
    if not worst <= LM_MESH_OUT:
        bad.append(f"{cfg.name} {label}: {errs}")


class RouteLog:
    """Inside the block, every MoE dispatch (``models/moe.dispatch``: the
    gathered step's and the partitioned step's alike) has its expert
    choices (T, k) and router probabilities (T, E) kept, in call order;
    ``take()`` returns and clears them."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._real = [], moe.dispatch

        def spy(*a, **k):
            route = self._real(*a, **k)
            self.calls.append((route.expert_idx.detach().clone(),
                               route.probs.detach().clone()))
            return route
        moe.dispatch = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.dispatch = self._real

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def route_diff(part: list, ref: list, L: int, G: int, M: int) -> tuple:
    """(every position of a group chose the same experts with the same
    probabilities bit for bit, the routing decisions of the partitioned
    step that differ from the gathered step's (a token sent to another
    set of experts: the order of its k choices changes no slot), those
    of them that are not near-ties, the first layer where one differs
    or None), from the first forward's calls: the gathered step's L x G
    (a group a call, layer by layer), the partitioned step's L x G x M
    (a position a call, row-major). A near-tie: the gathered step's
    margin between its k-th and (k+1)-th probability is at most twice
    the largest difference of the two steps' probabilities in that
    group and layer (float32 rounding apart, the two steps' inputs
    differ by ulps)."""
    import torch
    same, n, hard, first = True, 0, 0, None
    for l in range(L):
        for g in range(G):
            mine = part[(l * G + g) * M:(l * G + g + 1) * M]
            same &= all(bool(torch.equal(q[0], mine[0][0]))
                        and bool(torch.equal(q[1], mine[0][1]))
                        for q in mine[1:])
            (ep, pp), (er, pr) = mine[0], ref[l * G + g]
            k = er.shape[-1]
            moved = (ep.sort(-1).values != er.sort(-1).values).any(-1)
            if not bool(moved.any()):
                continue
            n += int(moved.sum())
            first = l if first is None else first
            top = pr.sort(-1, descending=True).values
            margin = top[:, k - 1] - top[:, k] if top.shape[-1] > k \
                else torch.full_like(top[:, 0], float("inf"))
            noise = float((pp - pr).abs().max())
            hard += int((moved & (margin > 2 * noise)).sum())
    return same, n, hard, first


def moe_mesh_bars(label: str, dtype, errs: dict, routes: dict,
                  bad: list) -> str:
    """The MoE mesh checks of one run: every group's positions route
    bit-equally; in float32 as the gathered step does at every layer but
    at near-ties (``route_diff``), and every error within TOL_MOE_MESH
    of max |ref|; in bf16 the errors (in bf16 ulps) within LM_MESH_OUT
    on outputs and LM_MESH_GRAD on gradients where no routing decision
    differs. Returns the line's text."""
    import torch
    f32 = dtype == torch.float32
    unit = 1.0 if f32 else BF16_ULP
    text = ", ".join(f"{k} {v / unit:.3g}" for k, v in errs.items())
    rtext = "; ".join(
        f"{k}: positions equal {same}, {n} decisions differ"
        + ("" if first is None else f" (first at layer {first}), "
           f"{n - hard} of them near-ties")
        for k, (same, n, hard, first) in routes.items())
    if not all(r[0] for r in routes.values()):
        bad.append(f"{label}: a group's positions routed apart: {rtext}")
    differ = any(r[1] for r in routes.values())
    if f32:
        if any(r[2] for r in routes.values()) or \
                max(errs.values()) > TOL_MOE_MESH:
            bad.append(f"{label} float32: {text}; {rtext}")
        return (f"float32, of max |ref| (limit {TOL_MOE_MESH}): {text}; "
                f"routing {rtext}")
    worst = {k: v / unit for k, v in errs.items()}
    over = [k for k, v in worst.items()
            if v > (LM_MESH_GRAD if k.startswith("grad") else LM_MESH_OUT)]
    if over and not differ:
        bad.append(f"{label} bf16: {text}")
    return (f"bf16 ulps of max |ref| (limits {LM_MESH_OUT} / "
            f"{LM_MESH_GRAD} where no decision differs): {text}; routing "
            f"{rtext}")


def moe_mesh_serve(cfg, params, mesh, rules, label: str, bad: list) -> None:
    """Prefill at B = LM_MESH_SERVE_B, S = LM_MESH_SEQ and LM_MESH_DECODE
    decode steps of an MoE config on the mesh under ``rules``, against
    the gathered steps (``prefill`` / ``decode_step`` over whole tensors
    under the same mesh rules: ``moe_ffn``'s branch, a group a data
    shard): the logits and the caches gathered from their pieces, and
    every layer's routing (``RouteLog``)."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import lm_rules
    from repro_torch.models import transformer as T
    from repro_torch.models import transformer_sharded as TS

    dev = params.embed.device
    B, S, L = LM_MESH_SERVE_B, LM_MESH_SEQ, cfg.n_layers
    G, M = mesh.shape["data"], mesh.shape["model"]
    tokens = torch.as_tensor(TokenStream(cfg.vocab, B, S, seed=6).batch_at(
        0)["tokens"], device=dev)
    errs, routes = {}, {}
    with RouteLog() as log, sh.use_mesh_rules(
            mesh, lm_rules("prefill", B, rules)):
        ref_logits, ref_cache = T.prefill(cfg, params, tokens)
        ref_calls = log.take()
        leaves = TS.place_params(params)
        torch.cuda.reset_peak_memory_stats()
        (logits, cache), p_ms = events_ms(
            lambda: TS.prefill(cfg, leaves, tokens))
        p_peak = torch.cuda.max_memory_allocated() / 2**30
        routes["prefill"] = route_diff(log.take(), ref_calls, L, G, M)
    errs["prefill logits"] = rel_err(logits.gather(dev), ref_logits)
    k0, v0 = cache["k"].gather(dev), cache["v"].gather(dev)
    errs["prefill cache k"] = rel_err(k0, ref_cache["k"])
    errs["prefill cache v"] = rel_err(v0, ref_cache["v"])
    del cache, logits
    slots = S + LM_MESH_DECODE
    ref = T.pad_cache(ref_cache, slots)
    mine = T.pad_cache({"k": k0, "v": v0, "len": S}, slots)
    del ref_cache, k0, v0
    token = ref_logits.argmax(-1)
    d_ms = []
    with RouteLog() as log, sh.use_mesh_rules(
            mesh, lm_rules("decode", B, rules)):
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        spec = sh.spec_for(tuple(mine["k"].shape), names, mesh)
        placed = {"k": sh.place(mine["k"], spec, mesh),
                  "v": sh.place(mine["v"], spec, mesh), "len": S}
        del mine
        for i in range(LM_MESH_DECODE):
            rl, ref = T.decode_step(cfg, params, ref, token)
            ref_calls = log.take()
            (ml, placed), t = events_ms(
                lambda: TS.decode_step(cfg, leaves, placed, token))
            d_ms.append(t)
            routes[f"decode {i}"] = route_diff(log.take(), ref_calls, L,
                                               G, M)
            errs[f"decode {i} logits"] = rel_err(ml.gather(dev), rl)
            token = rl.argmax(-1)
        errs["decode cache k"] = rel_err(placed["k"].gather(dev), ref["k"])
        errs["decode cache v"] = rel_err(placed["v"].gather(dev), ref["v"])
    del placed, ref, leaves
    text = moe_mesh_bars(f"{cfg.name} {label} serve", cfg.dtype, errs,
                         routes, bad)
    print(f"[lm-mesh] {cfg.name} {label} {str(cfg.dtype)[6:]} B = {B} on "
          f"{LM_MESH}: prefill {S} tokens {p_ms:.3f} ms (device peak "
          f"{p_peak:.3f} GiB), {LM_MESH_DECODE} decode steps ms "
          f"{[round(t, 3) for t in d_ms]}; against the gathered steps "
          f"({G} groups), {text}; port kernels launched none (the LM path "
          f"has none)")


def moe_mesh_train(cfg, params, mesh, rules, label: str, bad: list) -> None:
    """train_4k of an MoE config on the mesh under ``rules`` at B =
    MOE_TRAIN_BATCH, S = MOE_TRAIN_SEQ: the partitioned loss and each
    leaf's max |grad| (over its pieces' gradients) against the gathered
    ``lm_loss`` under the same mesh rules, and every layer's routing in
    the first forward of each."""
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.models import transformer_sharded as TS
    from repro_torch.train.trainer import value_and_grad

    dev = params.embed.device
    B, S, L = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, cfg.n_layers
    G, M = mesh.shape["data"], mesh.shape["model"]
    b = TokenStream(cfg.vocab, B, S, seed=5).batch_at(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    with RouteLog() as log, sh.use_mesh_rules(mesh, rules):
        ref_loss, ref_g = value_and_grad(
            lambda p, x: T.lm_loss(cfg, p, x["tokens"], x["targets"]),
            params, batch)
        ref_max = {n: g.abs().max() for n, g in ref_g.items()}
        del ref_g
        ref_calls = log.take()[:L * G]
        leaves = TS.place_params(params)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        (loss, grads), ms = events_ms(lambda: TS.value_and_grad(
            cfg, leaves, batch["tokens"], batch["targets"]))
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        routes = {"train": route_diff(log.take(), ref_calls, L, G, M)}
    errs = {"loss": rel_err(loss, ref_loss)}
    for n, parts in grads.items():
        got = torch.stack([g.abs().max() for g in parts.values()]).max()
        errs[f"grad {n}"] = rel_err(got, ref_max[n])
    del grads, leaves
    text = moe_mesh_bars(f"{cfg.name} {label} train", cfg.dtype, errs,
                         routes, bad)
    print(f"[lm-mesh] {cfg.name} {label} {str(cfg.dtype)[6:]} train_4k "
          f"B = {B} x {S} on {LM_MESH}: loss {float(loss):.6f} vs gathered "
          f"{float(ref_loss):.6f}; value and grad {ms:.3f} ms, device peak "
          f"{peak:.3f} GiB above the parameters; against the gathered step "
          f"({G} groups), {text}")


def moe_mesh_part(dev, mesh, bad: list) -> None:
    """Phase 3l's MoE mesh part: MOE_MESH_ARCHS at their published widths
    on the mesh, each placement (EP for both: "model" splits the
    experts; TP for mixtral: ``MOE_MESH_TP``, "model" splits d_ff) in
    float32 and in bf16: prefill and decode at LM_CUT_LAYERS, train at
    MOE_TRAIN_LAYERS."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cfg_base

    for arch in MOE_MESH_ARCHS:
        t0 = time.perf_counter()
        full = cfg_base.get(arch).full()
        places = [("EP", None)] + ([("TP", MOE_MESH_TP)]
                                   if arch == "mixtral-8x22b" else [])
        for layers, run in ((LM_CUT_LAYERS, moe_mesh_serve),
                            (MOE_TRAIN_LAYERS, moe_mesh_train)):
            cfg = dataclasses.replace(full, n_layers=layers)
            params = lm_params(cfg, dev)
            for name, rules in places:
                for dtype in (torch.float32, torch.bfloat16):
                    run(dataclasses.replace(cfg, dtype=dtype), params, mesh,
                        rules, f"{layers} of {full.n_layers} layers, {name}",
                        bad)
                    torch.cuda.empty_cache()
            del params
            torch.cuda.empty_cache()
        print(f"[lm-mesh] {arch} MoE mesh checks "
              f"{time.perf_counter() - t0:.1f}s")


def lm_mesh_part(dev) -> None:
    """Phase 3l's mesh part (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cfg_base

    t0 = time.perf_counter()
    mesh = card_mesh(LM_MESH, ("data", "model"), dev)
    bad: list = []
    cfg = cfg_base.get("smollm-135m").full()
    params = lm_params(cfg, dev)
    lm_mesh_train(cfg, params, mesh, dev, bad)
    lm_mesh_serve(cfg, params, mesh, dev, "serve", bad, census=True)
    del params
    torch.cuda.empty_cache()
    cfg = cfg_base.get("gemma3-1b").full()
    params = lm_params(cfg, dev)
    t1 = time.perf_counter()
    lm_mesh_train(cfg, params, mesh, dev, bad, predict="gemma3-1b",
                  steps=LM_MESH_GEMMA_STEPS, f32=False)
    print(f"[lm-mesh] gemma3-1b train {time.perf_counter() - t1:.1f}s")
    torch.cuda.empty_cache()
    lm_mesh_serve(cfg, params, mesh, dev, "serve", bad)
    del params
    torch.cuda.empty_cache()
    full = cfg_base.get("qwen3-14b").full()
    cfg = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)
    params = lm_params(cfg, dev)
    lm_mesh_serve(cfg, params, mesh, dev,
                  f"{LM_CUT_LAYERS} of {full.n_layers} layers", bad)
    del params
    torch.cuda.empty_cache()
    moe_mesh_part(dev, mesh, bad)
    print(f"[lm-mesh] part {time.perf_counter() - t0:.1f}s; card "
          f"{card_line()}")
    if bad:
        raise RuntimeError("phase 3l mesh part: " + "; ".join(bad))


def lm_phase(dev, profile: bool = False) -> None:
    """Phase 3l, the LM stack on the card at the published widths (see
    the module docstring); seeded weights, ``TokenStream`` data. With
    ``profile``, one more decode_32k and long_500k step is traced."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.launch.specs import LM_SHAPE_DEFS
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"[lm] {held:.3f} GiB held on the card by earlier phases")

    # ---- smollm-135m, whole: train_4k, prefill_32k, decode_32k, long_500k
    cfg = cfg_base.get("smollm-135m").full()
    lm_train(cfg, dev)
    params = lm_params(cfg, dev)
    d = LM_SHAPE_DEFS["prefill_32k"]
    cache = lm_prefill(cfg, params, 2, d["seq"], "prefill_32k")
    d = LM_SHAPE_DEFS["decode_32k"]
    per_seq = 2 * cache["k"][:, :1].numel() * cache["k"].element_size() \
        * d["seq"] / cache["k"].shape[2]
    B = pow2_at_most(LM_MEM_SHARE * free_bytes() / per_seq, d["batch"])
    big = cache_of(cache, B, d["seq"])
    del cache
    lm_decode(cfg, params, big, LM_DECODE_STEPS, d["seq"], "decode_32k",
              profile)
    del big
    torch.cuda.empty_cache()
    d = LM_SHAPE_DEFS["long_500k"]
    gen = torch.Generator(device=dev).manual_seed(4)
    shape = (cfg.n_layers, d["batch"], d["seq"], cfg.n_kv_heads, cfg.d_head)
    long = {n: torch.randn(shape, generator=gen, device=dev,
                           dtype=cfg.dtype) for n in ("k", "v")}
    long["len"] = d["seq"] - sum(LM_DECODE_STEPS) - 1
    lm_decode(cfg, params, long, LM_DECODE_STEPS, d["seq"], "long_500k",
              profile)
    del long
    lm_agreement(cfg, params, 2_047)
    del params
    torch.cuda.empty_cache()

    # ---- gemma3-1b, whole: prefill 32k at B = 1, decode at what is free
    cfg = cfg_base.get("gemma3-1b").full()
    params = lm_params(cfg, dev)
    d = LM_SHAPE_DEFS["decode_32k"]
    cache = lm_prefill(cfg, params, 1, d["seq"], "prefill_32k")
    per_seq = 2 * cache["k"].numel() * cache["k"].element_size()
    B = pow2_at_most(LM_MEM_SHARE * free_bytes() / per_seq, d["batch"])
    big = cache_of(cache, B, d["seq"])
    del cache
    lm_decode(cfg, params, big, LM_DECODE_STEPS, d["seq"], "decode_32k")
    del big
    lm_agreement(cfg, params, 2_047)
    del params
    torch.cuda.empty_cache()

    # ---- qwen3 / mixtral / scout: published widths, two layers --------
    for arch in ("qwen3-14b", "mixtral-8x22b", "llama4-scout-17b-a16e"):
        full = cfg_base.get(arch).full()
        cfg = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)
        params = lm_params(cfg, dev)
        n_par = sum(p.numel() for p in params.parameters())
        print(f"[lm] {arch}: {LM_CUT_LAYERS} of {full.n_layers} layers at "
              f"the published widths, {n_par:,} parameters "
              f"({n_par * 4 / 2**30:.2f} GiB float32)")
        cache = lm_prefill(cfg, params, 1, LM_CUT_PREFILL,
                           f"prefill {LM_CUT_PREFILL}")
        cache = T.pad_cache(cache, LM_CUT_PREFILL + sum(LM_CUT_DECODE))
        lm_decode(cfg, params, cache, LM_CUT_DECODE,
                  LM_CUT_PREFILL + sum(LM_CUT_DECODE), "short")
        del cache
        # a prompt past the window where there is one
        lm_agreement(cfg, params, max(2_047, cfg.window + 1_023))
        del params
        torch.cuda.empty_cache()
    lm_mesh_part(dev)
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f}s; card "
          f"{card_line()}")


# ----------------------------------------------------------------------
# phase 3m: the sharded models on meshes that repeat the one card
# ----------------------------------------------------------------------
def shardmap_gcn_step(shape: str, mesh):
    """The step of ``make_cell("gcn-cora", shape, mesh,
    variant="shardmap")``: the value and gradient of ``gcn_loss_sharded``,
    then AdamW's update (lr 1e-3), its loss returned as a tensor."""
    from repro_torch.launch.specs import make_cell
    fn = make_cell("gcn-cora", shape, mesh, variant="shardmap").fn

    def step(params, state, batch):
        params, state, metrics = fn(params, state, batch)
        return params, state, metrics["loss"]
    return step


def card_mesh(shape, axes, dev):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(shape, axes, devices=[dev] * math.prod(shape))


def timed_steps(step, params, state, batch, mesh, steps: tuple,
                save=None) -> tuple:
    """``steps`` (warm-up, timed) calls of a sharded ``step`` under
    ``mesh``, each timed by CUDA events from its call to its loss's
    read; ``save(k, params, state)`` after each. Returns (params, state,
    losses, timed ms)."""
    from repro_torch.launch.sharding import use_mesh_rules
    losses, ms = [], []
    with use_mesh_rules(mesh):
        for k in range(sum(steps)):
            def one():
                nonlocal params, state
                params, state, loss = step(params, state, batch)
                return float(loss)
            loss, t = events_ms(one)
            losses.append(loss)
            if k >= steps[0]:
                ms.append(t)
            if save is not None:
                save(k, params, state)
    return params, state, losses, ms


def step_stats(ms: list, flops: float) -> str:
    import numpy as np
    p50 = float(np.percentile(ms, 50))
    return (f"step ms (CUDA events, call to loss read) "
            f"{[round(t, 3) for t in ms]}, p50 {p50:.3f} max {max(ms):.3f}; "
            f"{flops / 1e12:.4f} TFLOP a step (gnn_model_flops), "
            f"{flops / p50 / 1e9:.3f} TFLOP/s at p50")


def leaf_errors(got: dict, ref: dict) -> dict:
    """{name: max |got - ref| / max |ref|} over a gradient tree."""
    return {n: float((got[n] - r).abs().max() / r.abs().max().clamp(
        min=1e-30)) for n, r in ref.items()}


def ogb_graph(seed: int):
    """``erdos_renyi`` at the ogb_products cell's n and m, seeded with
    ``seed``. ``powerlaw_fast`` cannot give this shape: its bounded
    Pareto sends over half of the draws to the first id, so at k = 25
    deduplication leaves 16.3 M of 61.2 M edges and a node of in-degree
    2,449,027, whose rows no contiguous split balances (PERF.md §4)."""
    from repro_torch.graph import generators
    from repro_torch.launch.specs import GNN_SHAPE_DEFS
    d = GNN_SHAPE_DEFS["ogb_products"]
    return generators.erdos_renyi(d["n"], d["m"], seed=seed)


def sharded_gcn_phase(dev, tmp, seed: int) -> None:
    """Phase 3m (a, b): the node-sharded GCN at the ogb_products shape on
    OGB_SHARDS shards of the card, held against the unsharded port;
    full_graph_sm at four shards; the elastic resume onto the two-shard
    mesh that ``remesh`` plans."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import gnn_batch
    from repro_torch.graph import generators
    from repro_torch.launch.sharding import (NamedSharding, tree_paths,
                                             tree_shardings, use_mesh_rules)
    from repro_torch.launch.specs import GNN_SHAPE_DEFS, gnn_model_flops
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_sharded import (build_sharded_gcn_batch,
                                                gcn_loss_sharded)
    from repro_torch.optim.adamw import AdamW, AdamWState, named_leaves
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.trainer import value_and_grad

    d = GNN_SHAPE_DEFS["ogb_products"]
    cfg = dataclasses.replace(cfg_base.get("gcn-cora").full(),
                              d_in=d["d_feat"])
    t0 = time.perf_counter()
    g = ogb_graph(seed)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = build_sharded_gcn_batch(g, d["d_feat"], cfg.n_classes,
                                   OGB_SHARDS, seed=seed)
    t_build = time.perf_counter() - t0
    bn = host["feats"].shape[0] // OGB_SHARDS
    per_shard = np.bincount(g.edge_dst // bn, minlength=OGB_SHARDS)
    print(f"[sharded-models] ogb_products: erdos_renyi({g.n:,}, {d['m']:,}, "
          f"seed={seed}) ({t_graph:.2f} s on the host): m={g.m:,} "
          f"({100 * (g.m / d['m'] - 1):+.4f}% of the "
          f"cell's {d['m']:,}), max in-degree {int(g.in_deg.max()):,}; "
          f"edges a shard {per_shard.tolist()}; build_sharded_gcn_batch "
          f"(ns={OGB_SHARDS}, e_max {host['blk_src'].shape[1]:,}) "
          f"{t_build:.3f} s on the host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    del host
    mesh4 = card_mesh((OGB_SHARDS,), ("data",), dev)
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    # ---- sharded vs unsharded loss and gradients, the same params ------
    with use_mesh_rules(mesh4):
        ls, gs = value_and_grad(
            lambda p, b: gcn_loss_sharded(cfg, p, b), params, batch)
    n = g.n
    full = {"feats": batch["feats"][:n], "labels": batch["labels"][:n],
            "node_mask": batch["node_mask"][:n],
            "edge_src": torch.as_tensor(g.edge_src, device=dev),
            "edge_dst": torch.as_tensor(g.edge_dst, device=dev),
            "edge_mask": torch.ones(g.m, device=dev)}
    lu, gu = value_and_grad(lambda p, b: G.loss_fn(cfg, p, b), params, full)
    del full
    err = {"loss": abs(float(ls) - float(lu)) / abs(float(lu)),
           **leaf_errors(gs, gu)}
    print(f"[sharded-models] ogb_products sharded ({OGB_SHARDS} shards of "
          f"the card) vs unsharded gnn.loss_fn on the card: loss "
          f"{float(ls):.7f} vs {float(lu):.7f}; relative errors (of the "
          f"loss, of each leaf's max |g|) {err} (limit {TOL_SHARDED})")
    if not max(err.values()) <= TOL_SHARDED:
        raise RuntimeError(f"the sharded GCN disagrees with the unsharded "
                           f"one: {err}")
    del gs, gu

    # ---- 1 + 5 sharded steps, saved after step RESUME_AT ----------------
    opt = AdamW(lr=1e-3)
    step = shardmap_gcn_step("ogb_products", mesh4)
    state = opt.init(params)
    ckpt = str(Path(tmp) / "gcn_sharded")
    saved = {}

    def save(k, p, s):
        if k + 1 == RESUME_AT:
            checkpoint.save(ckpt, RESUME_AT, p, s, extra={"mesh": [4, 1]})
            saved.update({nm: t.detach().clone() for nm, t in
                          tree_paths(p) + tree_paths(s)})
    params, state, losses, ms = timed_steps(step, params, state, batch,
                                            mesh4, OGB_STEPS, save)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = gnn_model_flops(cfg, g.n, g.m, d["d_feat"])
    print(f"[sharded-models] ogb_products {cfg.name} d_in={cfg.d_in} on "
          f"{OGB_SHARDS} shards: losses {losses}; "
          + step_stats(ms, flops) + f"; device peak {peak:.3f} GiB "
          f"({base:.3f} GiB allocated before the batch)")
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"ogb_products sharded losses: {losses}")
    del batch, params, state
    torch.cuda.empty_cache()

    # ---- the elastic resume on the two shards remesh plans --------------
    plan = elastic.remesh(2, 1, OGB_SHARDS, OGB_SHARDS)
    mesh2 = elastic.make_mesh_from_plan(plan, devices=[dev] * 2)
    t0 = time.perf_counter()
    host = build_sharded_gcn_batch(g, d["d_feat"], cfg.n_classes, 2,
                                   seed=seed)
    t_build2 = time.perf_counter() - t0
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    del host
    like = G.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    like_state = opt.init(like)
    ps = tree_shardings(like, mesh2)
    os_ = AdamWState(step=NamedSharding(mesh2, ()), m=ps, v=ps)
    t0 = time.perf_counter()
    rp, ro, mf = checkpoint.restore(ckpt, RESUME_AT, like, like_state,
                                    mesh2, ps, os_)
    t_restore = time.perf_counter() - t0
    got = {**{nm: t.gather() for nm, t in rp.items()},
           **{nm: t.gather() for nm, t in tree_paths(ro)}}
    same = got.keys() == saved.keys() and all(
        torch.equal(got[nm], t) for nm, t in saved.items())
    with torch.no_grad():
        for nm, p in named_leaves(like):
            p.copy_(got[nm])
    state = AdamWState(step=got[".step"],
                       m={nm: got[f".m/{nm}"] for nm in like_state.m},
                       v={nm: got[f".v/{nm}"] for nm in like_state.v})
    _, _, resumed, ms2 = timed_steps(step, like, state, batch, mesh2,
                                     (0, 2))
    rel = [abs(a - b) / abs(b) for a, b in
           zip(resumed, losses[RESUME_AT:RESUME_AT + 2])]
    print(f"[sharded-models] elastic resume: step {mf['step']} saved on "
          f"{OGB_SHARDS} shards, remesh(2, ...) -> mesh {plan.mesh_shape} "
          f"grad_accum {plan.grad_accum}; build_sharded_gcn_batch(ns=2) "
          f"{t_build2:.3f} s on the host; restore under the new mesh's "
          f"tree_shardings {t_restore:.3f} s; every gathered leaf equal "
          f"bits to the saved one: {same}; two more steps {resumed} vs "
          f"the uninterrupted run's {losses[RESUME_AT:RESUME_AT + 2]} "
          f"(relative {rel}, limit {TOL_SHARDED}); 2-shard step ms "
          f"{[round(t, 3) for t in ms2]}")
    if not same or not max(rel) <= TOL_SHARDED:
        raise RuntimeError(f"elastic resume: equal bits {same}, loss "
                           f"errors {rel}")
    del batch, like, state, got, rp, ro, saved
    torch.cuda.empty_cache()

    # ---- full_graph_sm on four shards, beside the unsharded step --------
    d = GNN_SHAPE_DEFS["full_graph_sm"]
    cfg = dataclasses.replace(cfg_base.get("gcn-cora").full(),
                              d_in=d["d_feat"])
    gs_ = generators.barabasi_albert(d["n"], 2, seed=0, directed=False)
    flops = gnn_model_flops(cfg, gs_.n, gs_.m, d["d_feat"])
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             build_sharded_gcn_batch(gs_, d["d_feat"], cfg.n_classes, 4,
                                     seed=seed).items()}
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    mesh4 = card_mesh((4,), ("data",), dev)
    _, _, l4, ms4 = timed_steps(shardmap_gcn_step("full_graph_sm", mesh4),
                                params, opt.init(params), batch, mesh4,
                                GNN_STEPS)
    from repro_torch.train.steps import gnn_train_step
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plain = gnn_batch(gs_, d["d_feat"], cfg.n_classes, seed=seed)
    plain = {k: torch.as_tensor(v, device=dev) for k, v in plain.items()}
    ustep = gnn_train_step(cfg, opt)

    def unsharded(p, s, b):
        p, s, m = ustep(p, s, b)
        return p, s, m["loss"]
    _, _, l1, ms1 = timed_steps(unsharded, params, opt.init(params), plain,
                                None, GNN_STEPS)
    print(f"[sharded-models] full_graph_sm {cfg.name} on 4 shards: losses "
          f"{l4}; " + step_stats(ms4, flops) + f"; unsharded in the same "
          f"run: losses {l1}; " + step_stats(ms1, flops))
    if not all(math.isfinite(l) for l in l4 + l1):
        raise RuntimeError(f"full_graph_sm sharded losses {l4}, {l1}")
    if not max(abs(a - b) / abs(b) for a, b in zip(l4, l1)) <= TOL_SHARDED:
        raise RuntimeError(f"full_graph_sm: sharded losses {l4} vs "
                           f"unsharded {l1}")


def gnn_mesh_batch(cfg, dev, cut_n: int, cut_m: int, seed: int) -> tuple:
    """(batch on the card, n, m) for phase 3m's GNN part: the
    ogb_products n and m divided by ``cut_n`` / ``cut_m``, padded as the
    cell pads them (to multiples of 512), uniform random edges over the
    n real nodes, the padded edges and rows masked, normal features and
    uniform labels; for graphcast, GNN_MESH_GRID's grid as the mesh with
    phase 3k's layout (n grid nodes, then the mesh; 2n g2m and m2g
    edges)."""
    import numpy as np
    import torch

    from repro_torch.graph import generators
    from repro_torch.launch.specs import GNN_SHAPE_DEFS, _pad512
    d = GNN_SHAPE_DEFS["ogb_products"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32, i32 = torch.float32, torch.int32
    if cfg.kind == "graphcast":
        gm = generators.grid2d(*GNN_MESH_GRID)
        n, N = gm.n, 2 * gm.n
        rng = np.random.default_rng(seed)
        host = {"edge_src": gm.edge_src + n, "edge_dst": gm.edge_dst + n,
                "g2m_src": rng.integers(0, n, N),
                "g2m_dst": rng.integers(n, N, N),
                "m2g_src": rng.integers(n, N, N),
                "m2g_dst": rng.integers(0, n, N)}
        b = {k: torch.as_tensor(v.astype(np.int32), device=dev)
             for k, v in host.items()}
        b.update({
            "feats": torch.randn((N, d["d_feat"]), generator=gen,
                                 device=dev),
            "edge_mask": torch.ones(gm.m, device=dev),
            "node_mask": torch.ones(N, device=dev),
            "n_grid": torch.tensor(n, dtype=i32, device=dev),
            "g2m_mask": torch.ones(N, device=dev),
            "m2g_mask": torch.ones(N, device=dev),
            "targets": torch.randn((N, cfg.n_vars), generator=gen,
                                   device=dev)})
        return b, n, gm.m
    n, m = d["n"] // cut_n, d["m"] // cut_m
    n_pad, m_pad = _pad512(n), _pad512(m)
    ids = torch.randint(0, n, (2, m_pad), generator=gen, device=dev,
                        dtype=i32)
    b = {"feats": torch.randn((n_pad, d["d_feat"]), generator=gen,
                              device=dev),
         "edge_src": ids[0], "edge_dst": ids[1],
         "edge_mask": (torch.arange(m_pad, device=dev) < m).to(f32),
         "node_mask": (torch.arange(n_pad, device=dev) < n).to(f32),
         "labels": torch.randint(0, cfg.n_classes, (n_pad,), generator=gen,
                                 device=dev, dtype=i32)}
    return b, n, m


def rounded(errs: dict) -> dict:
    return {k: float(f"{v:.3g}") for k, v in errs.items()}


def placed_state(opt, model, mesh):
    """The AdamW state of ``model`` placed as a train cell places it."""
    from repro_torch.launch import sharding as sh
    from repro_torch.optim.adamw import AdamWState
    state = opt.init(model)
    shards = sh.tree_shardings(model, mesh)
    return AdamWState(step=sh.place(state.step, (), mesh),
                      m={n: shards[n].shard(t) for n, t in state.m.items()},
                      v={n: shards[n].shard(t) for n, t in state.v.items()})


def max_g_errors(got: dict, ref: dict) -> dict:
    """{name: | max |got| - max |ref| | / max |ref|} over a gradient
    tree."""
    return {n: float(abs(got[n].abs().max() - r.abs().max())
                     / r.abs().max().clamp(min=1e-30)) for n, r in ref.items()}


def gnn_mesh_compare(cfg, params, batch, mesh) -> dict:
    """The unpartitioned ``loss_fn`` and the partitioned step's value and
    gradient on the same parameters and batch: their losses, gradients
    (the partitioned step's first position's copy), device ms and peaks
    above what was held before, whether every copy is equal, and a
    second unpartitioned run's entrywise distance from the first (the
    card's atomic adds)."""
    import torch

    from repro_torch.launch import sharding as sh
    from repro_torch.models import gnn as G
    from repro_torch.models import gnn_sharded as GS
    from repro_torch.train.trainer import value_and_grad

    out = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (out["lu"], out["gu"]), out["ms_u"] = events_ms(lambda: value_and_grad(
        lambda p, b: G.loss_fn(cfg, p, b), params, batch))
    out["peak_u"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    torch.cuda.reset_peak_memory_stats()
    with sh.use_mesh_rules(mesh):
        (out["lp"], gp), out["ms_p"] = events_ms(lambda: GS.value_and_grad(
            cfg, params, batch))
    out["peak_p"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    first = next(iter(gp[next(iter(gp))]))
    out["gp"] = {k: v[first] for k, v in gp.items()}
    out["same"] = all(torch.equal(v[first], x) for v in gp.values()
                      for x in v.values())
    out["loss_err"] = abs(float(out["lp"]) - float(out["lu"])) \
        / abs(float(out["lu"]))
    out["spread"] = leaf_errors(value_and_grad(
        lambda p, b: G.loss_fn(cfg, p, b), params, batch)[1], out["gu"])
    return out


def gnn_mesh_part(dev, seed: int = 0) -> None:
    """Phase 3m's GNN part (see the module docstring): for each kind the
    partitioned value and gradient against the unpartitioned ``loss_fn``
    on the card, in float64 (the loss and each leaf's max |g| held within
    TOL_SHARDED) and in float32 (printed beside the unpartitioned
    float32 step's own distance to float64: the reordered float32 sums
    of these gradients differ by more than TOL_SHARDED); then
    GNN_MESH_STEPS partitioned float32 train steps: their ms, the peak
    and the host launches of one."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import GNN_SHAPE_DEFS, gnn_model_flops
    from repro_torch.models import gnn as G
    from repro_torch.models.transformer_sharded import place_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import gnn_train_step_sharded

    t_part = time.perf_counter()
    mesh = card_mesh(GNN_MESH, ("data", "model"), dev)
    d_feat = GNN_SHAPE_DEFS["ogb_products"]["d_feat"]
    bad = []
    for arch, cut_n, cut_m in GNN_MESH_CASES + (("graphcast", 0, 0),):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(cfg_base.get(arch).full(), d_in=d_feat)
        gc.collect()
        torch.cuda.empty_cache()
        batch, n, m = gnn_mesh_batch(cfg, dev, cut_n, cut_m, seed)
        params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed))
        held = torch.cuda.memory_allocated() / 2**30
        f32 = gnn_mesh_compare(cfg, params, batch, mesh)
        wide = {k: v.double() if v.is_floating_point() else v
                for k, v in batch.items()}
        f64 = gnn_mesh_compare(cfg, copy.deepcopy(params).double(), wide,
                               mesh)
        del wide
        err64 = {"loss": f64["loss_err"], **max_g_errors(f64["gp"],
                                                          f64["gu"])}
        err32 = {"loss": f32["loss_err"], **max_g_errors(f32["gp"],
                                                          f32["gu"])}
        whole32 = max_g_errors(f32["gu"], f64["gu"])
        part32 = max_g_errors(f32["gp"], f64["gu"])
        entry64 = leaf_errors(f64["gp"], f64["gu"])
        entry32 = leaf_errors(f32["gp"], f32["gu"])
        # the partitioned float32 train step on a copy
        model = copy.deepcopy(params)
        opt = AdamW(lr=1e-3)
        step = gnn_train_step_sharded(cfg, opt)

        def loss_step(p, s, b):
            p, s, met = step(p, s, b)
            return p, s, met["loss"]
        with sh.use_mesh_rules(mesh):
            leaves = place_params(model)
            state = placed_state(opt, model, mesh)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            leaves, state, losses, times = timed_steps(
                loss_step, leaves, state, batch, mesh, GNN_MESH_STEPS)
            peak_s = (torch.cuda.max_memory_allocated() - base) / 2**30
            census = launch_census(lambda: step(leaves, state, batch), 1)
        flops = gnn_model_flops(cfg, n, m, d_feat)
        p50 = float(np.percentile(times, 50))
        print(f"[sharded-models] gnn {arch} on {GNN_MESH} of the card "
              f"(n={n:,}, m={m:,}"
              + (f", grid2d{GNN_MESH_GRID} mesh" if cut_n == 0 else
                 f", the ogb_products n / {cut_n}, m / {cut_m}")
              + f"; {held:.3f} GiB held before the steps): float64 loss "
              f"{float(f64['lp']):.12f} partitioned vs "
              f"{float(f64['lu']):.12f} unpartitioned, relative errors (of "
              f"the loss, of each leaf's max |g|) {rounded(err64)} (limit "
              f"{TOL_SHARDED}), entrywise of max |g| {rounded(entry64)} "
              f"(two unpartitioned runs {rounded(f64['spread'])}); "
              f"float32 loss {float(f32['lp']):.7f} vs "
              f"{float(f32['lu']):.7f}, relative errors {rounded(err32)}, "
              f"entrywise {rounded(entry32)} (two unpartitioned runs "
              f"{rounded(f32['spread'])}), max |g| vs float64's: "
              f"unpartitioned {rounded(whole32)}, partitioned "
              f"{rounded(part32)}; every copy's gradient equal "
              f"{f32['same'] and f64['same']}; float32 value and grad ms "
              f"(each step's first call) {f32['ms_p']:.3f} partitioned vs "
              f"{f32['ms_u']:.3f} "
              f"unpartitioned (float64 {f64['ms_p']:.3f} vs "
              f"{f64['ms_u']:.3f}), peak above the batch and params "
              f"{f32['peak_p']:.3f} vs {f32['peak_u']:.3f} GiB; "
              f"{GNN_MESH_STEPS[1]} timed train steps after "
              f"{GNN_MESH_STEPS[0]}: losses {[round(l, 5) for l in losses]}, "
              + step_stats(times, flops)
              + f"; steps' peak above the model and its state {peak_s:.3f} "
              f"GiB; host launches a step {census['host']:.0f} "
              f"({census['by_name']}), device kernels "
              f"{census['kernels']:.0f}, device busy "
              f"{census['busy_pct']:.1f} % of {census['wall_ms']:.3f} ms "
              f"(p50 {p50:.3f}); {time.perf_counter() - t0:.1f} s")
        finite = [float(f32["lp"]), float(f32["lu"]), float(f64["lp"])]
        if not max(err64.values()) <= TOL_SHARDED or not f32["same"] or \
                not f64["same"] or not all(math.isfinite(l)
                                           for l in losses + finite):
            bad.append(f"{arch}: float64 errors {err64}, copies equal "
                       f"{f32['same']} {f64['same']}, losses {losses} "
                       f"{finite}")
        del batch, params, model, leaves, state, step, loss_step, f32, f64
    print(f"[sharded-models] gnn part {time.perf_counter() - t_part:.1f}s")
    if bad:
        raise RuntimeError("phase 3m gnn part: " + "; ".join(bad))


def moe_drops(x, router_w, k: int, cf: float, groups: int) -> list:
    """Assignments past their expert's capacity in each of ``groups``
    contiguous token groups of ``x`` (T, d): ``_moe_local``'s routing,
    counted."""
    import torch

    from repro_torch.models.moe import _top_k
    out = []
    E = router_w.shape[-1]
    for xl in x.split(x.shape[0] // groups):
        probs = torch.softmax(xl.to(torch.float32)
                              @ router_w.to(torch.float32), -1)
        _, ids = _top_k(probs, k)
        C = max(1, int(math.ceil(xl.shape[0] * k / E * cf)))
        counts = torch.bincount(ids.reshape(-1), minlength=E)
        out.append(int((counts - C).clamp(min=0).sum()))
    return out


def moe_branch_check(cfg, call, groups: int, mesh, label: str) -> None:
    """One recorded ``moe_ffn`` call (the first MoE layer's tokens and
    weights) through the mesh branch against the port's own
    composition of ``_moe_local`` over the ``groups`` contiguous
    groups, bit for bit; prints each group's dropped assignments and
    the one-group path's."""
    import torch

    from repro_torch.launch.sharding import use_mesh_rules
    from repro_torch.models import moe as M
    x, w = call
    with torch.no_grad():
        with use_mesh_rules(mesh):
            y, aux = M.moe_ffn(x, *w, cfg.moe_top_k, cfg.capacity_factor)
        parts = [M._moe_local(xl, *w, cfg.moe_top_k, cfg.capacity_factor)
                 for xl in x.split(x.shape[0] // groups)]
    same = torch.equal(y, torch.cat([p[0] for p in parts])) and \
        torch.equal(aux, torch.stack([p[1] for p in parts]).mean())
    per = moe_drops(x, w[0], cfg.moe_top_k, cfg.capacity_factor, groups)
    one = moe_drops(x, w[0], cfg.moe_top_k, cfg.capacity_factor, 1)
    print(f"[sharded-models] {cfg.name} {label}: the mesh branch at T = "
          f"{x.shape[0]:,} ({groups} groups of {x.shape[0] // groups:,}) "
          f"equals the composition of _moe_local bit for bit: {same}; "
          f"assignments dropped a group {per} (capacity "
          f"{max(1, math.ceil(x.shape[0] // groups * cfg.moe_top_k / cfg.moe_experts * cfg.capacity_factor))}"
          f" each), by the one-group path {one[0]} (capacity "
          f"{max(1, math.ceil(x.shape[0] * cfg.moe_top_k / cfg.moe_experts * cfg.capacity_factor))})")
    if not same:
        raise RuntimeError(f"{cfg.name} {label}: the MoE mesh branch "
                           "differs from its per-group composition")


def moe_mesh_phase(dev, tmp) -> None:
    """Phase 3m (c, d): the MoE layer's mesh branch in mixtral-8x22b and
    llama4-scout cut to LM_CUT_LAYERS layers, a train step under the
    mesh at mixtral cut to one layer, and that model's checkpoint
    restored under a (2, 2) mesh."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.sharding import tree_shardings, use_mesh_rules
    from repro_torch.launch.specs import lm_model_flops
    from repro_torch.models import moe as M
    from repro_torch.optim.adamw import AdamW, named_leaves
    from repro_torch.train import checkpoint
    from repro_torch.train.steps import lm_train_step

    mesh = card_mesh((MOE_GROUPS,), ("data",), dev)
    real = M.moe_ffn
    for arch in ("mixtral-8x22b", "llama4-scout-17b-a16e"):
        full = cfg_base.get(arch).full()
        cfg = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)
        params = lm_params(cfg, dev)
        calls = []

        def spy(x, *w):
            if len(calls) < 2 and (not calls or x.shape != calls[0][0].shape):
                calls.append((x.detach(), [t.detach() for t in w[:4]]))
            return real(x, *w)
        M.moe_ffn = spy
        try:
            with use_mesh_rules(mesh):
                cache = lm_prefill(cfg, params, 1, LM_CUT_PREFILL,
                                   f"prefill {LM_CUT_PREFILL} on a "
                                   f"{MOE_GROUPS}-group mesh")
                slots = LM_CUT_PREFILL + sum(LM_DECODE_STEPS) + 1
                big = cache_of(cache, MOE_DECODE_B, slots)
                del cache
                lm_decode(cfg, params, big, LM_CUT_DECODE, slots,
                          f"on a {MOE_GROUPS}-group mesh")
                del big
        finally:
            M.moe_ffn = real
        for k, label in enumerate(("prefill, layer 0", "decode, layer 0")):
            moe_branch_check(cfg, calls[k], MOE_GROUPS, mesh, label)
        calls.clear()          # the recorded weights are views of params
        del params, spy
        torch.cuda.empty_cache()

    # ---- one train step under the mesh: mixtral cut to MOE_TRAIN_LAYERS
    cfg = dataclasses.replace(cfg_base.get("mixtral-8x22b").full(),
                              n_layers=MOE_TRAIN_LAYERS)
    params = lm_params(cfg, dev)
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    S, B = MOE_TRAIN_SEQ, MOE_TRAIN_BATCH
    batch = TokenStream(cfg.vocab, B, S, seed=5).batch_at(0)
    n_par = sum(p.numel() for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    step = lm_train_step(cfg, opt)
    with use_mesh_rules(mesh):
        (params, state, m), t = events_ms(lambda: step(params, state, batch))
    loss = float(m["loss"])
    flops = lm_model_flops(cfg, "train", B, S)
    print(f"[sharded-models] {cfg.name} {MOE_TRAIN_LAYERS} layer(s) at the "
          f"published widths ({n_par:,} parameters, {held:.3f} GiB held "
          f"with the AdamW state): one lm_train_step on the "
          f"{MOE_GROUPS}-group mesh at B = {B} x S = {S:,} ({B * S // MOE_GROUPS:,} "
          f"tokens a group): loss {loss:.6f}, {t:.3f} ms (CUDA events), "
          f"{flops / 1e12:.3f} TFLOP (lm_model_flops), "
          f"{flops / t / 1e9:.3f} TFLOP/s; device peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not math.isfinite(loss):
        raise RuntimeError(f"{cfg.name}: the mesh train step's loss {loss}")
    del state, step, opt
    torch.cuda.empty_cache()

    # ---- that model saved, restored under a (2, 2) mesh ----------------
    ckpt = str(Path(tmp) / "lm_mesh")
    t0 = time.perf_counter()
    checkpoint.save(ckpt, 1, params)
    t_save = time.perf_counter() - t0
    m22 = card_mesh((2, 2), ("data", "model"), dev)
    ps = tree_shardings(params, m22)
    t0 = time.perf_counter()
    rp, _, _ = checkpoint.restore(ckpt, 1, params, None, m22, ps)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    covered, equal, cut = True, True, 0
    for nm, t in named_leaves(params):
        st = rp[nm]
        idx = st.sharding.devices_indices_map(st.shape)
        distinct = {tuple((s.start, s.stop) for s in sl): pos
                    for pos, sl in idx.items()}
        covered &= all(tuple(st.pieces[pos].shape) == tuple(
            s.stop - s.start for s in sl) for pos, sl in idx.items())
        covered &= sum(st.pieces[pos].numel() for pos in
                       distinct.values()) == t.numel()
        cut += len(distinct) == 4
        equal &= torch.equal(st.gather(), t.detach())
    print(f"[sharded-models] {cfg.name} checkpoint ({n_par * 4 / 2**30:.2f} "
          f"GiB float32) saved in {t_save:.2f} s, restored under a (2, 2) "
          f"mesh's tree_shardings in {t_restore:.2f} s: "
          f"{cut} of {len(rp)} leaves cut four ways; pieces cover the "
          f"slices their placement reports: {covered}; gathered equal "
          f"bits: {equal}")
    if not covered or not equal or cut == 0:
        raise RuntimeError(f"LM restore under (2, 2): covered {covered}, "
                           f"equal {equal}, cut {cut}")
    del rp, params
    torch.cuda.empty_cache()


def sharded_models_phase(dev, tmp, seed: int = 0) -> None:
    """Phase 3m, the sharded models on meshes that repeat the card (see
    the module docstring)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[sharded-models] {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB held on the card by earlier phases")
    sharded_gcn_phase(dev, tmp, seed)
    gnn_mesh_part(dev, seed)
    moe_mesh_phase(dev, tmp)
    print(f"[sharded-models] phase {time.perf_counter() - t_phase:.1f}s; "
          f"card {card_line()}")


# ----------------------------------------------------------------------
# phase 3n: cells on the card's (1, 1) mesh, predicted and measured
# ----------------------------------------------------------------------
def _cell_cfg(arch: str, shape: str):
    """The config a cell of ``arch`` x ``shape`` is made from (as
    ``launch/specs.py`` makes it)."""
    import dataclasses

    from repro_torch.configs import base as cfg_base
    from repro_torch.launch.specs import GNN_SHAPE_DEFS
    cfg = cfg_base.get(arch).full()
    if cfg_base.get(arch).family == "gnn":
        cfg = dataclasses.replace(cfg, d_in=GNN_SHAPE_DEFS[shape]["d_feat"])
    return cfg


def sling_cell_inputs(cell, host, dev, seed: int):
    """The sling-serve cell's (index, graph, batch) from phase 3i's graph
    and index (``host``), padded to the cell's n: each key l*n0 + k
    re-encoded as l*n + k, rows and the row width padded with PAD
    (values 0), d with zeros, the edges (Â's pull weights) in the one
    "model" block with weight-0 slots after them; ``cell.args[2]``'s B
    distinct sources drawn from ``seed``. Also Â over the padded nodes,
    for the plain push."""
    import numpy as np
    import torch

    from repro_torch.core.hp_index import INT32_PAD_KEY
    from repro_torch.graph import csr
    from repro_torch.kernels.spmv_ell import SpmmLayout
    index, graph, batch = cell.args
    g = host["g"]
    n, W = index["keys"].shape
    e_max = graph["blk_src"].shape[1]
    n0, w0 = host["keys"].shape
    if w0 > W or g.m > e_max:
        raise RuntimeError(f"phase 3i's index (width {w0}, {g.m} edges) "
                           f"does not fit the cell's ({W}, {e_max})")
    k = host["keys"].long()
    pad = k == INT32_PAD_KEY
    keys = torch.full((n, W), INT32_PAD_KEY, dtype=torch.int32)
    keys[:n0, :w0] = torch.where(pad, INT32_PAD_KEY,
                                 (k // n0) * n + k % n0).int()
    vals = torch.zeros((n, W), dtype=torch.float32)
    vals[:n0, :w0] = host["vals"]
    d = torch.zeros(n, dtype=torch.float32)
    d[:n0] = host["d"]
    cfg = _cell_cfg("sling-serve", "serve_batch")
    w = csr.normalized_pull_weights(g, cfg.c ** 0.5).astype(np.float32)
    blk = {"blk_src": np.zeros((1, e_max), np.int32),
           "blk_dstl": np.zeros((1, e_max), np.int32),
           "blk_w": np.zeros((1, e_max), np.float32)}
    blk["blk_src"][0, :g.m] = g.edge_src
    blk["blk_dstl"][0, :g.m] = g.edge_dst
    blk["blk_w"][0, :g.m] = w
    us = np.random.default_rng(seed).choice(n0, batch["us"].shape[0],
                                            replace=False).astype(np.int32)
    lay = SpmmLayout.from_edges(g.edge_src, g.edge_dst, w, n, dev)
    return ({"d": d.to(dev), "keys": keys.to(dev), "vals": vals.to(dev)},
            {k_: torch.as_tensor(v, device=dev) for k_, v in blk.items()},
            {"us": torch.as_tensor(us, device=dev)}), lay


def cell_inputs(cell, arch: str, shape: str, dev, seed: int) -> tuple:
    """Real tensors on ``dev`` of ``cell``'s argument tree, from
    ``seed``: the family's ``init_params``, AdamW's state where the step
    trains, and a batch (``RecsysStream``'s ids; for a GNN uniform
    edges over the cell's own n and m, masked past them, normal
    features and uniform labels)."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.launch.specs import GNN_SHAPE_DEFS
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys
    from repro_torch.optim.adamw import AdamW
    cfg = _cell_cfg(arch, shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = cell.args[-1]
    if arch == "xdeepfm":
        params = recsys.init_params(cfg, gen, device=dev)
        b = RecsysStream(cfg.n_fields, cfg.vocab_per_field,
                         spec["ids"].shape[0],
                         multi_hot_fields=cfg.multi_hot_fields,
                         bag_size=cfg.bag_size, seed=seed).batch_at(0)
    else:
        params = G.init_params(cfg, gen, device=dev)
        d = GNN_SHAPE_DEFS[shape]
        rng = np.random.default_rng(seed)
        n, m = spec["feats"].shape[0], spec["edge_src"].shape[0]
        b = {"feats": rng.normal(size=(n, d["d_feat"])).astype(np.float32),
             "edge_src": rng.integers(0, d["n"], m).astype(np.int32),
             "edge_dst": rng.integers(0, d["n"], m).astype(np.int32),
             "edge_mask": (np.arange(m) < d["m"]).astype(np.float32),
             "node_mask": (np.arange(n) < d["n"]).astype(np.float32),
             "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}
    batch = {k: torch.as_tensor(b[k], device=dev) for k in spec}
    if len(cell.args) == 3:
        return params, AdamW(lr=1e-3).init(params), batch
    return params, batch


def placed_bytes(placed) -> int:
    """Bytes of the distinct storages of placed arguments (each leaf's
    pieces), as the dry run's walk counts its argument bytes."""
    seen, total = set(), 0
    for p in placed:
        for leaf in p.leaves.values():
            for t in leaf.pieces.values():
                st = t.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
    return total


def cells_phase(dev, sling_host, seed: int) -> dict:
    """Phase 3n (see the module docstring). Returns the launches of the
    cells' first steps, by the names of the kernel rows' counts."""
    import numpy as np
    import torch

    from repro_torch.core.single_source import release_workspaces
    from repro_torch.kernels import cin as kcin
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_rows_plain,
                                                 horner_push_slabs)
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import make_cell
    from repro_torch.train.steps import _sling_tau

    counters = {"horner_push_rows": horner_push_rows,
                "horner_push_slabs": horner_push_slabs,
                "cin_layer": kcin.cin_layer, "cin_grad_xk": kcin.cin_grad_xk,
                "cin_grad_x0": kcin.cin_grad_x0,
                "cin_grad_w": kcin.cin_grad_w, "hp_join": hp_join,
                "spmm": spmm}
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cells] {torch.cuda.memory_allocated() / 2**30:.3f} GiB held "
          f"on the card by earlier phases")
    mesh = card_mesh((1, 1), ("data", "model"), dev)
    bad = []
    first = {}
    for arch, shape, steps in CELLS_3N:
        torch.cuda.empty_cache()
        rec = dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)
        cell = make_cell(arch, shape, mesh)
        lay = None
        if arch == "sling-serve":
            args, lay = sling_cell_inputs(cell, sling_host, dev, seed)
        else:
            args = cell_inputs(cell, arch, shape, dev, seed)
        placed = cell.place(args)
        arg_bytes = placed_bytes(placed)
        step = cell.jitted()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, first_ms = events_ms(lambda: step(*placed))
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        for k, v in launches.items():
            k = {"horner_push_rows": "horner_push",
                 "cin_layer": "cin"}.get(k, k)
            first[k] = first.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() - before + arg_bytes
        err = None
        if lay is not None:
            index, _, batch = args
            plain = horner_push_rows_plain(
                index["keys"], index["vals"], index["d"], batch["us"][:8],
                lay, _sling_tau(_cell_cfg(arch, shape)), l_max=_cell_cfg(
                    arch, shape).l_max)
            err = float((out[:8] - plain).abs().max())
            if not err <= TOL_KERNEL:
                bad.append(f"{arch} first 8 rows vs the plain push {err}")
            del plain, index, batch
        del out
        ms = []
        for k in range(sum(steps)):
            o, t = events_ms(lambda: step(*placed))
            del o
            if k >= steps[0]:
                ms.append(t)
        p50 = float(np.percentile(ms, 50))
        census = launch_census(lambda: step(*placed), 1)
        bpd, r = rec["bytes_per_device"], rec["roofline"]
        t_roof = max(r["t_compute_s"], r["t_memory_s"],
                     r["t_collective_s"]) * 1e3
        copies = sum(census["by_name"].get(k, 0) for k in
                     ("cudaMemcpyAsync", "cudaMemsetAsync"))
        print(f"[cells] {arch} x {rec['shape']} on (1, 1) of the card: "
              f"dry run {rec['t_lower_s']} s, {rec['n_ops']} ops, worst "
              f"cases {rec['worst_cases']}; argument bytes predicted "
              f"{bpd['argument']:,} measured {arg_bytes:,}; device peak "
              f"predicted {bpd['peak_est'] / 2**30:.3f} GiB measured "
              f"{peak / 2**30:.3f} GiB; roofline step {t_roof:.4f} ms "
              f"({r['bottleneck']}) vs p50 {p50:.3f} ms (first call "
              f"{first_ms:.3f} ms, timed {[round(t, 3) for t in ms]}): "
              f"{100 * t_roof / p50:.2f} % of it; bottleneck predicted "
              f"{r['bottleneck']} measured "
              f"{'host' if census['busy_pct'] < 50 else 'device'} (device "
              f"busy {census['busy_pct']:.1f} %); port kernels predicted "
              f"{rec['kernels']} launched {launches}; walk ops "
              f"{rec['n_ops']} vs profiler kernels {census['kernels']:.0f} "
              f"+ copies and memsets {copies:.0f} a step"
              + ("" if err is None else f"; first 8 rows vs the plain push "
                 f"{err:.3g} (TOL_KERNEL {TOL_KERNEL})"))
        if bpd["argument"] != arg_bytes:
            bad.append(f"{arch} x {shape}: argument bytes predicted "
                       f"{bpd['argument']} measured {arg_bytes}")
        if rec["kernels"] != launches:
            bad.append(f"{arch} x {shape}: launches predicted "
                       f"{rec['kernels']} counted {launches}")
        del placed, args, step, lay
    # the sling cell's push scratch (B = 1,024 at n = 10^6, 16 GB) is
    # cached for the next push; the LM cells need the memory
    release_workspaces()
    lm_cell_3n(dev, counters, bad, seed)
    torch.cuda.empty_cache()
    lm_cell_3n(dev, counters, bad, seed, CELL_3N_MOE)
    torch.cuda.empty_cache()
    gnn_cell_3n(dev, counters, bad, seed)
    print(f"[cells] phase {time.perf_counter() - t_phase:.1f}s; card "
          f"{card_line()}")
    if bad:
        raise RuntimeError("phase 3n: " + "; ".join(bad))
    return first


def lm_cell_3n(dev, counters: dict, bad: list, seed: int,
               which: tuple = CELL_3N_LM) -> None:
    """Phase 3n's LM cell ``which`` (CELL_3N_LM, CELL_3N_MOE: arch, shape,
    steps, the batch and the layers cut to (None: all)) on a (2, 2) mesh
    of the card: the dry run's record on the same mesh, then
    ``cell.jitted()`` (the partitioned train step, every argument read
    as its placed pieces) on real arguments made on the host from
    ``seed`` and placed on the card, a copy a position. A cut cell's
    measured peak must be within CELL_3N_PEAK of the prediction."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW

    arch, shape, steps, batch, layers = which
    saved, spec = specs.LM_SHAPE_DEFS, cfg_base.get(arch)
    specs.LM_SHAPE_DEFS = dict(saved, **{shape: dict(saved[shape],
                                                     batch=batch)})
    if layers is not None:
        cut = dataclasses.replace(spec.full(), n_layers=layers)
        cfg_base._REGISTRY[arch] = dataclasses.replace(spec,
                                                       full=lambda: cut)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    try:
        mesh = card_mesh((2, 2), ("data", "model"), dev)
        rec = dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)
        cell = specs.make_cell(arch, shape, mesh)
        cfg = _cell_cfg(arch, shape)
    finally:
        specs.LM_SHAPE_DEFS = saved
        cfg_base._REGISTRY[arch] = spec
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    b = TokenStream(cfg.vocab, batch, cell.args[2]["tokens"].shape[1],
                    seed=seed).batch_at(0)
    args = (params, AdamW(lr=1e-4).init(params),
            {k: torch.as_tensor(b[k]) for k in cell.args[2]})
    placed = cell.place(args)
    del args, params
    cut = "" if layers is None else \
        f", {layers} of {spec.full().n_layers} layers"
    mesh_cell_3n(f"{arch} x {shape} B = {batch} of the cell's "
                 f"{saved[shape]['batch']}{cut}", rec, cell, placed,
                 counters, bad, steps, held, layers is not None)


def mesh_cell_3n(label: str, rec: dict, cell, placed, counters: dict,
                 bad: list, steps: tuple, held: float,
                 hold_peak: bool) -> None:
    """Phase 3n's measurement of a cell on a (2, 2) mesh of the card:
    ``cell.jitted()`` on ``placed`` (real arguments placed a copy a
    position), each predicted value of the dry run's record ``rec``
    beside the measured one; fails on argument bytes or launches that
    differ, a loss that is not finite, and (``hold_peak``) a device peak
    more than CELL_3N_PEAK from the prediction."""
    import numpy as np
    import torch

    arg_bytes = placed_bytes(placed)
    step = cell.jitted()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, first_ms = events_ms(lambda: step(*placed))
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated() - before + arg_bytes
    losses = [float(out[2]["loss"])]
    del out
    ms = []
    for k in range(sum(steps)):
        o, t = events_ms(lambda: step(*placed))
        losses.append(float(o[2]["loss"]))
        del o
        if k >= steps[0]:
            ms.append(t)
    bpd, r = rec["bytes_per_device"], rec["roofline"]
    t_roof = max(r["t_compute_s"], r["t_memory_s"],
                 r["t_collective_s"]) * 1e3
    p50 = float(np.percentile(ms, 50))
    print(f"[cells] {label} on (2, 2) of the card ({held:.3f} GiB held on "
          f"the card before it): dry run {rec['t_lower_s']} s, "
          f"{rec['n_ops']} ops, collectives {rec['collectives']}; argument "
          f"bytes predicted {bpd['argument']:,} measured {arg_bytes:,}; "
          f"device peak predicted {bpd['peak_est'] / 2**30:.3f} GiB "
          f"measured {peak / 2**30:.3f} GiB; roofline step {t_roof:.4f} ms "
          f"({r['bottleneck']}) vs p50 {p50:.3f} ms (first call "
          f"{first_ms:.3f} ms, timed {[round(t, 3) for t in ms]}); losses "
          f"{[round(l, 4) for l in losses]}; port kernels predicted "
          f"{rec['kernels']} launched {launches}")
    if bpd["argument"] != arg_bytes:
        bad.append(f"{label} on (2, 2): argument bytes predicted "
                   f"{bpd['argument']} measured {arg_bytes}")
    if rec["kernels"] != launches:
        bad.append(f"{label} on (2, 2): launches predicted "
                   f"{rec['kernels']} counted {launches}")
    if not all(math.isfinite(l) for l in losses):
        bad.append(f"{label} on (2, 2): losses {losses}")
    if hold_peak and abs(peak / bpd["peak_est"] - 1) > CELL_3N_PEAK:
        bad.append(f"{label} on (2, 2): device peak predicted "
                   f"{bpd['peak_est']} measured {peak}")
    del placed, step


def gnn_cell_3n(dev, counters: dict, bad: list, seed: int) -> None:
    """Phase 3n's GNN cell on a (2, 2) mesh of the card: pna x
    ogb_products where the dry run of that mesh predicts a peak under
    CELL_3N_GNN_BAR GiB, else gat-cora x ogb_products; its real
    arguments (``cell_inputs``) made on the host and placed on the card a
    copy a position, its peak held within CELL_3N_PEAK of the
    prediction."""
    import torch

    from repro_torch.launch import dryrun, specs

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    mesh = card_mesh((2, 2), ("data", "model"), dev)
    shape = "ogb_products"
    for arch in CELL_3N_GNN:
        rec = dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)
        pred = rec["bytes_per_device"]["peak_est"] / 2**30
        print(f"[cells] {arch} x {shape} on (2, 2) of the card: the dry "
              f"run predicts a peak of {pred:.3f} GiB (bar "
              f"{CELL_3N_GNN_BAR})")
        if pred < CELL_3N_GNN_BAR:
            break
    cell = specs.make_cell(arch, shape, mesh)
    placed = cell.place(cell_inputs(cell, arch, shape, torch.device("cpu"),
                                    seed))
    mesh_cell_3n(f"{arch} x {shape}", rec, cell, placed, counters, bad,
                 CELL_3N_GNN_STEPS, held, True)


def cin_grad_rows(model, batch, dev, launches: dict, train_ms: dict,
                  errors: dict) -> list[dict]:
    """The three CIN gradient kernels at the serve_p99 shapes (the three
    layers of one batch on the model's embeddings, g unit normal): times
    (CUDA events), the 3xTF32 bound (operations 3 x 2*B*D*h*m*h' summed
    over the layers; bytes x0, xk, W, g read once and the gradient
    written once), the plain version's time and, as the library call,
    ``torch.autograd.grad`` of that input through one ``torch.einsum`` a
    layer. ``train_ms`` is each kernel family's device time in phase
    3j's traced step; ``errors`` each kernel's (abs, relative) error
    against its plain version, from phase 3j's check at this shape."""
    import torch

    from repro_torch.kernels import cin as kcin
    from repro_torch.kernels.cin import cin as kc
    from repro_torch.kernels.cin import ref
    from repro_torch.kernels.cost import total

    plain = {"cin_grad_x0": lambda x0, xk, W, g: ref.cin_grad_x0_plain(
                 xk, W, g),
             "cin_grad_xk": lambda x0, xk, W, g: ref.cin_grad_xk_plain(
                 x0, W, g),
             "cin_grad_w": lambda x0, xk, W, g: ref.cin_grad_w_plain(
                 x0, xk, g)}
    layers = grad_cases(model, batch, dev, 4)["model"]
    B, m, D = layers[0][0].shape
    slot = {"cin_grad_x0": 0, "cin_grad_xk": 1, "cin_grad_w": 2}
    # one einsum a layer, its graph kept: the library call is the grad
    leaves = [[t.clone().requires_grad_(True) for t in (x0, xk, W)]
              for x0, xk, W, _ in layers]
    ys = [torch.einsum("ihm,bhd,bmd->bid", W, xk, x0)
          for x0, xk, W in leaves]
    gs = [g for *_, g in layers]
    # the pre-passes inside the wrappers' times, each a tuple of outputs:
    # dx0's split of W permuted and of g by rows, dW's g transposed and
    # split; each held to its plain version's bits
    prepass = {"cin_grad_x0": (
                   lambda W, g: (kc.split_weights_x0_on_card(W),
                                 kc.split_grad_rows_on_card(g)),
                   lambda W, g: (kc.split_weights_x0(W),
                                 kc.split_grad_rows(g))),
               "cin_grad_w": (lambda W, g: (kc.split_grad_t_on_card(g),),
                              lambda W, g: (kc.split_grad_t(g),))}
    pre = {}
    for k, (card_fn, plain_fn) in prepass.items():
        same = all(torch.equal(x, y) for _, _, W, g in layers
                   for x, y in zip(card_fn(W, g), plain_fn(W, g)))
        if not same:
            raise RuntimeError(f"{k}'s pre-pass disagrees with its plain "
                               f"version")
        pre[k] = tuple(time_ms(lambda: [fn(W, g) for _, _, W, g in layers],
                               reps) for fn, reps in ((card_fn, 20),
                                                      (plain_fn, 5)))
    rows = []
    for k in GRAD_KERNELS:
        fn = getattr(kcin, k)
        err, rel = errors[k]
        with torch.no_grad():
            outs = [fn(*a) for a in layers]
            cost = total(kc.cin_grad_cost(*a, o) for o, a in
                         zip(outs, layers))
            b_ms, b_by = cost.bound_ms()
            ms = time_ms(lambda: [fn(*a) for a in layers], 20)
            p_ms = time_ms(lambda: [plain[k](*a) for a in layers], 5)
        wrt = [lv[slot[k]] for lv in leaves]
        lib_ms = time_ms(lambda: torch.autograd.grad(
            ys, wrt, gs, retain_graph=True), 5)
        lib = torch.autograd.grad(ys, wrt, gs, retain_graph=True)
        e_lib = max(rel_err(a, b) for a, b in zip(lib, outs))
        mode = {"cin_grad_x0": "dx0", "cin_grad_xk": "layer",
                "cin_grad_w": "wgrad"}[k]
        row = {"name": k, "route": "cuda",
               "source": "src/repro_torch/csrc/cin.cu",
               "replaces": "src/repro/kernels/cin/cin.py:37",
               "launches": launches[k], "max_abs_err": err, "ms": ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "rel_err": rel,
               "train_step_mode_ms": train_ms.get(mode),
               "prepass_ms": pre.get(k, (None,))[0],
               "shape": f"B={B} m={m} D={D} layers "
                        + "-".join(str(W.shape[1]) for _, _, W, _ in layers)
                        + f"-{layers[-1][2].shape[0]}"}
        print(f"[kernel] {k}: vs plain {rel:.3g} of max |grad| (phase 3j, "
              f"bound {TOL_CIN}), the einsum autograd library call vs the "
              f"kernel {e_lib:.3g}; {cost.flops / 1e9:.2f} GFLOP (x3 on "
              f"the tensor cores), kernel at {cost.flops / ms / 1e9:.2f} "
              f"TFLOP/s"
              + (f"; its pre-pass (in ms) {pre[k][0]:.4f} ms, plain "
                 f"{pre[k][1]:.4f} ms, equal bits" if k in pre else ""))
        rows.append(row)
        del outs, lib
    return rows


def accuracy(label: str, eng, S, eps: float) -> None:
    """Every pair, single-source and top-k (k = 10) answer of ``eng``
    within eps + 1e-5 of the exact SimRank matrix ``S``."""
    import numpy as np
    n = S.shape[0]
    tol = eps + 1e-5
    uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    acc = {"pair": float(np.abs(eng.pairs(uu.ravel(), vv.ravel())
                                .reshape(n, n) - S).max()),
           "source": float(np.abs(eng.single_source(np.arange(n))
                                  - S).max())}
    sv, si = eng.topk(np.arange(n), 10)
    acc["topk"] = float(np.abs(sv - S[np.arange(n)[:, None], si]).max())
    # a returned node's exact score is at most 2 tol below the exact
    # 10th best (both sides are within tol of exact)
    kth = np.sort(S, axis=1)[:, ::-1][:, 9]
    gap = float(max(0.0, (kth[:, None] - S[np.arange(n)[:, None], si]).max()))
    st = eng.stats()
    print(f"[accuracy] {label}: n={n} eps={eps} max |err| {acc} (bound "
          f"{tol:.6g}); top-k rank gap {gap:.3g} (bound {2 * tol:.6g}); "
          f"pair={st['pair_backend']} push={st['push_backend']} "
          f"quantized={st['quantized']}")
    if max(acc.values()) > tol or gap > 2 * tol:
        raise RuntimeError(f"{label} answers beyond eps of exact "
                           f"SimRank: {acc}")


def accuracy_phase(dev) -> None:
    """Phase 5: on a 64-node graph with the exact diagonal, the float32
    index, an int16 and a bf16 index mapped from v3 files and served by
    the engine, and the reduced, enhanced index's host pairs, each
    within its eps + 1e-5 of exact SimRank (power method)."""
    import numpy as np

    from repro_torch.baselines import power
    from repro_torch.core import build, quantize
    from repro_torch.graph import generators
    from repro_torch.serve import EngineConfig, QueryEngine

    small = generators.barabasi_albert(64, 3, seed=1, directed=False)
    S = power.all_pairs(small, c=0.6, iters=power.iterations_for(1e-9, 0.6))
    sidx = build.build_index(small, eps=EPS, c=0.6, exact_d=True,
                             device=dev)
    accuracy("float32", QueryEngine(sidx, small, EngineConfig(
        cache_size=0), device=dev), S, sidx.plan.eps)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # int16 (quant_frac 0.25) and bf16 (eps 0.2, quant_frac 0.8,
        # float32 d: vmax = 1 needs 2^-8 <= the vals bound), each through
        # a v3 file mapped and served on the card
        for scheme, eps, frac, qd in (("int16", EPS, 0.25, True),
                                      ("bf16", 0.2, 0.8, False)):
            qidx = quantize.quantize_index(build.build_index(
                small, eps=eps, c=0.6, exact_d=True, quant_frac=frac,
                device=dev), scheme, quantize_d=qd)
            f = str(Path(tmp) / f"{scheme}.sling")
            qidx.save(f)
            qeng = QueryEngine.from_index_file(
                f, small, EngineConfig(cache_size=0), mmap=True, device=dev)
            accuracy(f"{scheme} mmap", qeng, S, eps)
    ridx = build.build_index(small, eps=EPS, c=0.6, exact_d=True,
                             space_reduce=True, enhance=True, device=dev)
    n = small.n
    host = np.array([[ridx.query_pair_host(u, v, small) for v in range(n)]
                     for u in range(n)])
    e_host = float(np.abs(host - S).max())
    print(f"[accuracy] reduced + enhanced ({int(ridx.reduced.sum())} of "
          f"{n} rows reduced): query_pair_host(u, v, g) max |err| "
          f"{e_host:.3g} (bound {EPS + 1e-5:.6g})")
    if not e_host <= EPS + 1e-5:
        raise RuntimeError(f"host pairs beyond eps of exact: {e_host}")


def serve_sample(eng, pair_u, pair_v, src_q, top_q):
    """Phase 3's sample through ``eng``: pairs in batches of 64, then
    single-source and top-k (k = 10) batches of 8 in turn. Returns
    ({kind: answers per batch}, {kind: host seconds per batch})."""
    answers = {"pair": [], "source": [], "topk": []}
    lat = {"pair": [], "source": [], "topk": []}
    for lo in range(0, len(pair_u), 64):
        t = time.perf_counter()
        answers["pair"].append(eng.pairs(pair_u[lo:lo + 64],
                                         pair_v[lo:lo + 64]))
        lat["pair"].append(time.perf_counter() - t)
    for lo in range(0, len(src_q), 8):
        t = time.perf_counter()
        answers["source"].append(eng.single_source(src_q[lo:lo + 8]))
        lat["source"].append(time.perf_counter() - t)
        t = time.perf_counter()
        answers["topk"].append(eng.topk(top_q[lo:lo + 8], 10))
        lat["topk"].append(time.perf_counter() - t)
    return answers, lat


def answer_arrays(answers) -> dict:
    """{pair, source, topk, topk_ids}: each kind's answers as one array."""
    import numpy as np
    return {"pair": np.concatenate(answers["pair"]),
            "source": np.concatenate(answers["source"]),
            "topk": np.concatenate([a[0] for a in answers["topk"]]),
            "topk_ids": np.concatenate([a[1] for a in answers["topk"]])}


def answer_diff(a, b) -> dict:
    """max |a - b| of two samples' scores, kind by kind."""
    import numpy as np
    x, y = answer_arrays(a), answer_arrays(b)
    return {k: float(np.abs(x[k] - y[k]).max())
            for k in ("pair", "source", "topk")}


def artifact_phase(g, idx, answers, queries, dev, tmp) -> dict:
    """Phase 3d, the index artifact at the Enron regime (see the module
    docstring). ``idx`` and ``answers`` are phase 3's index and sample,
    ``queries`` the sample's (pair_u, pair_v, src_q, top_q); the files
    go to ``tmp``. The counters are zeroed before the quantized build and
    read after its mapped index served; that index's answers are then
    held against the same plan's float32 index on the card. The v3 file
    of phase 3's index stays in ``tmp`` (``enron.sling``) for phases 3f
    and 3g. Returns the launches of the path."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import build, quantize, theory
    from repro_torch.core.index import SlingIndex
    from repro_torch.device import synchronize
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    def timed(fn):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t

    def same_tensors(a, b) -> bool:
        return all(torch.equal(x.to(dev), y.to(dev)) for x, y in (
            (a.d, b.d), (a.hp.keys, b.hp.keys), (a.hp.vals, b.hp.vals),
            (a.hp.counts, b.hp.counts)))

    ref = answer_arrays(answers)
    kv_bytes = idx.hp.keys.nbytes + idx.hp.vals.nbytes

    # ---- the float32 index of phase 3: v3 and v2 round trips ----------
    path = os.path.join(tmp, "enron.sling")
    _, t_save = timed(lambda: idx.save(path))
    eager, t_eager = timed(lambda: SlingIndex.load(path, device=dev))
    mapped, t_map = timed(lambda: SlingIndex.load(path, mmap=True))
    if not (same_tensors(eager, idx) and same_tensors(mapped, idx)
            and eager.plan == idx.plan and mapped.read_only):
        raise RuntimeError("the v3 round trip changed the index")
    del eager, mapped
    feng, t_inst = timed(lambda: QueryEngine.from_index_file(
        path, g, EngineConfig(), mmap=True, device=dev))
    feng.warmup()
    got, lat = serve_sample(feng, *queries)
    got = answer_arrays(got)
    bit_equal = {k: bool(np.array_equal(got[k], ref[k])) for k in ref}
    print(f"[artifact] v3 float32: {os.path.getsize(path):,} bytes "
          f"(keys + vals {kv_bytes:,}); save {t_save:.3f}s, load eager "
          f"on the card {t_eager:.3f}s, load mmap {t_map * 1e3:.3f} ms, "
          f"from_index_file(mmap) install {t_inst * 1e3:.1f} ms; served "
          + " ".join(f"{k} p50 {1e3 * np.median(v):.3f} ms"
                     for k, v in lat.items())
          + f"; equal bits to phase 3: {bit_equal}")
    if not all(bit_equal.values()):
        raise RuntimeError(f"the mapped artifact's answers differ from "
                           f"phase 3's: {bit_equal}")
    del feng
    path2 = os.path.join(tmp, "enron.npz")
    _, t_save2 = timed(lambda: idx.save(path2, version=2))
    v2, t_load2 = timed(lambda: SlingIndex.load(path2, device=dev))
    print(f"[artifact] v2 .npz: {os.path.getsize(path2):,} bytes; save "
          f"{t_save2:.3f}s, load eager on the card {t_load2:.3f}s; equal: "
          f"{same_tensors(v2, idx)}")
    if not same_tensors(v2, idx):
        raise RuntimeError("the v2 round trip changed the index")
    del v2
    os.remove(path2)

    # ---- quantized: build, int16, save, map, serve --------------------
    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    qbase, t_build = timed(lambda: build.build_index(
        g, eps=EPS, c=0.6, seed=0, block=BLOCK, quant_frac=QUANT_FRAC,
        device=dev))
    p = qbase.plan
    b_vals = theory.quant_vals_bound(p, d_channel=True)
    b_d = theory.quant_d_bound(p)
    iq, t_quant = timed(lambda: quantize.quantize_index(qbase, "int16"))
    qpath = os.path.join(tmp, "enron-int16.sling")
    _, t_qsave = timed(lambda: iq.save(qpath))
    qeng, t_qinst = timed(lambda: QueryEngine.from_index_file(
        qpath, g, EngineConfig(), mmap=True, device=dev))
    qeng.warmup()
    qans, qlat = serve_sample(qeng, *queries)
    synchronize(dev)
    path_launches = {k: kern.launches for k, kern in kernels.items()}
    path_launches["horner_push_steps"] = horner_push_rows.steps
    quantized = qeng.stats()["quantized"]
    del qeng
    # checks, outside the count: the same plan's float32 index on the card
    feng = QueryEngine(qbase, g, EngineConfig(), device=dev)
    fans, _ = serve_sample(feng, *queries)
    del feng
    diff = answer_diff(qans, fans)
    charge = theory.quant_charge(p, b_vals, b_d)
    pay_fp = qbase.hp.vals.nbytes + 4 * qbase.n
    pay_q = iq.hp.vals.nbytes + 2 * iq.n
    try:
        quantize.quantize_index(qbase, "bf16")
        bf16 = "not refused"
    except ValueError as e:
        bf16 = f"refused ({e})"
    print(f"[artifact] quant_frac={QUANT_FRAC}: eps_quant={p.eps_quant:.6g}"
          f" b_vals={b_vals:.6g} b_d={b_d:.6g} quant_charge={charge:.6g}; "
          f"build {t_build:.2f}s, quantize_index(int16) on the card "
          f"{t_quant * 1e3:.1f} ms (scale {iq.quant.scale:.6g}, d_scale "
          f"{iq.quant.d_scale:.6g}), save {t_qsave:.3f}s, "
          f"{os.path.getsize(qpath):,} bytes; from_index_file(mmap) "
          f"install with the dequantize {t_qinst * 1e3:.1f} ms; "
          f"stats quantized={quantized}")
    print(f"[artifact] int16 served: "
          + " ".join(f"{k} p50 {1e3 * np.median(v):.3f} ms"
                     for k, v in qlat.items())
          + f"; launches {path_launches}; max |int16 - float32| {diff} "
          f"(bound {charge:.6g}); float payload {pay_q:,} / {pay_fp:,} = "
          f"{pay_q / pay_fp:.4f} (gate 0.6); bf16 at this plan: {bf16}")
    os.remove(qpath)
    if quantized != "int16" or max(diff.values()) > charge \
            or pay_q > 0.6 * pay_fp or not bf16.startswith("refused"):
        raise RuntimeError("the quantized artifact failed its checks")
    del iq, qbase

    # ---- Section 5: space reduction and enhancement ---------------------
    red, t_red = timed(lambda: build.build_index(
        g, eps=EPS, c=0.6, seed=0, block=BLOCK, space_reduce=True,
        enhance=True, device=dev))
    entries = int(idx.hp.counts.sum())
    saved = 8 * (entries - int(red.hp.counts.sum()))
    spath = os.path.join(tmp, "enron-reduced.sling")
    _, t_ssave = timed(lambda: red.save(spath))
    round_trip = {}
    for mmap in (False, True):
        back = SlingIndex.load(spath, mmap=mmap,
                               device=None if mmap else dev)
        round_trip["mmap" if mmap else "eager"] = bool(
            np.array_equal(back.reduced, red.reduced)
            and np.array_equal(back.marks, red.marks)
            and same_tensors(back, red))
        del back
    try:
        QueryEngine(red, g, device=dev)
        refused = "served"
    except ValueError:
        refused = "refused"
    rng = np.random.default_rng(4)
    hu, hv = rng.integers(0, g.n, (2, 64))
    t = time.perf_counter()
    host_red = np.array([red.query_pair_host(int(u), int(v), g)
                         for u, v in zip(hu, hv)])
    t_host = (time.perf_counter() - t) / len(hu)
    host_full = np.array([idx.query_pair_host(int(u), int(v))
                          for u, v in zip(hu, hv)])
    gap = float(np.abs(host_red - host_full).max())
    print(f"[section5] build_index(space_reduce, enhance) {t_red:.2f}s "
          f"(d {red.build_seconds['d']:.2f}s, hp "
          f"{red.build_seconds['hp']:.2f}s, Section 5 on the host "
          f"{t_red - sum(red.build_seconds.values()):.2f}s): "
          f"{int(red.reduced.sum()):,} of {g.n:,} rows reduced, "
          f"{saved:,} bytes saved ({entries:,} -> "
          f"{int(red.hp.counts.sum()):,} entries), rows marked "
          f"{int((red.marks >= 0).any(1).sum()):,} (budget "
          f"{red.marks.shape[1]}); v3 {os.path.getsize(spath):,} bytes, "
          f"save {t_ssave:.3f}s, round trip equal {round_trip}; "
          f"QueryEngine: {refused}")
    print(f"[section5] 64 host pairs, query_pair_host(u, v, g) "
          f"{t_host * 1e3:.2f} ms each; reduced+enhanced vs unreduced, "
          f"max |diff| {gap:.3g}:")
    cells = [f"s({u},{v})={a:.6f}/{b:.6f}"
             for u, v, a, b in zip(hu, hv, host_red, host_full)]
    for lo in range(0, len(cells), 8):
        print("[section5]   " + " ".join(cells[lo:lo + 8]))
    os.remove(spath)
    if not all(round_trip.values()) or refused != "refused" \
            or not gap <= 2 * EPS:
        raise RuntimeError("the Section-5 index failed its checks")
    if min(path_launches.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the artifact "
                           f"path: {path_launches}")
    return path_launches


class RssPeak:
    """The peak resident set of this process from its making to
    ``stop()``, from ``/proc/self/statm`` read every 5 ms on a thread
    (VmHWM cannot be reset, or is absent, on some kernels): ``peak_mb``,
    and ``start_mb`` at the making; ``None`` where statm cannot be
    read. ``whole_mb`` is ``ru_maxrss``, the peak of the whole
    process."""

    def __init__(self):
        import os
        import threading
        self.peak_mb = None
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._sample()
        self.start_mb = self.peak_mb
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        try:
            with open("/proc/self/statm") as f:
                mb = int(f.read().split()[1]) * self._page / 2**20
        except (OSError, ValueError, IndexError):
            return
        self.peak_mb = max(self.peak_mb or 0.0, mb)

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self._sample()

    def stop(self) -> None:
        import resource
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()
        self.whole_mb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0


def same_but_builder(a: str, b: str) -> bool:
    """Two v3 files equal byte for byte outside the header's ``builder``
    field: the preambles and headers equal with ``builder`` dropped,
    and every byte after the header equal (read in 64 MiB pieces)."""
    import struct
    heads = []
    for path in (a, b):
        with open(path, "rb") as f:
            magic, version, hlen = struct.unpack("<8sII", f.read(16))
            head = json.loads(f.read(hlen))
        head.pop("builder")
        heads.append((magic, version, head, 16 + hlen))
    if heads[0] != heads[1]:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        fa.seek(heads[0][3])
        fb.seek(heads[1][3])
        while True:
            x, y = fa.read(1 << 26), fb.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def profile_sparse_build(g, p, dev, blocks: int = 4) -> None:
    """Trace ``blocks`` tail blocks of 4,096 targets and ``blocks`` hub
    batches of 128 of the scale build's sparse propagation."""
    import numpy as np

    from repro_torch.core import hp_index
    from repro_torch.prsim import hub_set, reverse_pagerank
    og = hp_index.OutGraph.from_graph(g, p.sqrt_c, dev)
    hubs = hub_set(reverse_pagerank(g, device=dev)[0])
    tail = np.setdiff1d(np.arange(g.n), hubs)

    def run():
        for i in range(blocks):
            hp_index._sparse_targets_coo(og, hubs[128 * i:128 * (i + 1)],
                                         p.theta, p.l_max)
            hp_index._sparse_targets_coo(og, tail[4096 * i:4096 * (i + 1)],
                                         p.theta, p.l_max)
    run()                                               # warm
    trace(f"sparse build at n={g.n:,}: {blocks} hub batches of 128 and "
          f"{blocks} tail blocks of 4,096 targets", run)


def scale_phase(dev, tmp, profile: bool = False):
    """Phase 3e, the scale path at 10^6 nodes (see the module docstring):
    ``build_index_scale`` with ``builder="auto"`` and again with
    ``"sling"``, the mapped file loaded and served by two engines
    (single-source and top-k batches of 2 and of 8, pairs in a batch of
    64). The counters are zeroed before the first build and read after
    the last batch; the comparison with the plain-backend engine runs
    after. Returns the path's launches and (g, plan, the B = 8 engine)
    for phase 4."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import build
    from repro_torch.core.index import SlingIndex
    from repro_torch.device import synchronize
    from repro_torch.graph import generators
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    def timed(fn):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t

    rss = RssPeak()
    torch.cuda.reset_peak_memory_stats()
    g, t_gen = timed(lambda: generators.powerlaw_fast(N_SCALE, k=6, seed=0))
    print(f"[scale] powerlaw_fast({N_SCALE:,}, k=6, seed=0) in "
          f"{t_gen:.2f}s: n={g.n:,} m={g.m:,} max in-degree="
          f"{int(g.in_deg.max()):,}")
    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    files, stats = {}, {}
    for builder in ("auto", "sling"):
        files[builder] = os.path.join(tmp, f"scale-{builder}.sling")
        stats[builder], wall = timed(lambda: build.build_index_scale(
            g, files[builder], eps=SCALE_EPS, quant_frac=QUANT_FRAC,
            quantize="int16", builder=builder, device=dev))
        st = stats[builder]
        print(f"[scale] build_index_scale(eps={SCALE_EPS}, quant_frac="
              f"{QUANT_FRAC}, int16, builder={builder!r}) -> "
              f"{st['builder']}, d_mode={st['d_mode']}: d "
              f"{st['d_wall_s']:.3f}s, hp {st['hp_wall_s']:.3f}s, pack "
              f"{st['pack_wall_s']:.3f}s, total {wall:.3f}s; entries "
              f"{st['entries']:,}, width {st['width']}, "
              f"{st['bytes']:,} bytes; prsim {st.get('prsim')}; skew "
              f"{st.get('skew')}")
    auto = stats["auto"]
    if auto["builder"] != "prsim" or auto["d_mode"] != "estimate" \
            or stats["sling"]["builder"] != "sling":
        raise RuntimeError(f"the scale build chose {auto['builder']} / "
                           f"{auto['d_mode']}, not prsim / estimate")
    same = same_but_builder(files["auto"], files["sling"])
    print(f"[scale] prsim file == sling file outside the header's "
          f"builder field: {same}")
    if not same:
        raise RuntimeError("the prsim and sling scale files differ")
    os.remove(files["sling"])
    path = files["auto"]
    idx, t_load = timed(lambda: SlingIndex.load(path, mmap=True))
    p = idx.plan
    engines, t_inst = {}, {}
    for B in (2, 8):
        engines[B], t_inst[B] = timed(lambda: QueryEngine.from_index_file(
            path, g, EngineConfig(pair_batch=64, source_batch=B),
            mmap=True, device=dev))
    rng = np.random.default_rng(5)
    q = rng.choice(g.n, 160, replace=False).astype(np.int32)
    # the hub and the widest row among the sources, and 8 pairs (u, u)
    q[0] = int(np.argmax(g.in_deg))
    q[1] = int(np.argmax(idx.hp.counts.numpy()))
    lat, got = {}, {}
    for B, eng in engines.items():
        for kind, fn in (("source", eng.single_source),
                         ("topk", lambda us: eng.topk(us, 10))):
            for lo in range(0, 2 * B, B):
                us = q[lo:lo + B] if kind == "source" \
                    else q[16 + lo:16 + lo + B]
                out, t = timed(lambda: fn(us))
                lat.setdefault(f"{kind} B={B}", []).append(t)
                got.setdefault((kind, B), []).append((us, out))
    pair_u, pair_v = q[32:96], q[96:160].copy()
    pair_v[:8] = pair_u[:8]
    pairs, t_pair = timed(lambda: engines[2].pairs(pair_u, pair_v))
    lat["pair 64"] = [t_pair]
    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    rss.stop()
    dev_peak = torch.cuda.max_memory_allocated() / 2**30
    st = engines[8].stats()
    print(f"[scale] SlingIndex.load(mmap) {t_load * 1e3:.3f} ms; "
          f"from_index_file(mmap) install B=2 {t_inst[2] * 1e3:.1f} ms, "
          f"B=8 {t_inst[8] * 1e3:.1f} ms (width bucket "
          f"{engines[8]._width_cap}); backends pair={st['pair_backend']} "
          f"push={st['push_backend']} quantized={st['quantized']}")
    print("[scale] served: " + "; ".join(
        f"{k} " + "/".join(f"{1e3 * t:.3f}" for t in v) + " ms"
        for k, v in lat.items()) + f"; launches {launches}")
    phase_peak = ("not measured (no /proc/self/statm)"
                  if rss.peak_mb is None else f"{rss.peak_mb:.1f} MiB "
                  f"(at its start {rss.start_mb:.1f} MiB)")
    print(f"[scale] peak host RSS of the phase {phase_peak} (statm "
          f"every 5 ms), of the whole process {rss.whole_mb:.1f} MiB "
          f"(ru_maxrss); peak device memory {dev_peak:.3f} GiB; card "
          f"{card_line()}")
    if launches["hp_join"] <= 0 or launches["horner_push"] <= 0:
        raise RuntimeError(f"a kernel did not launch on the scale path: "
                           f"{launches}")
    if st["pair_backend"] != "kernel" or st["push_backend"] != "kernel":
        raise RuntimeError(f"the scale path did not use the kernels: {st}")

    # checks, outside the count: the plain backends on the card
    plain = QueryEngine(idx, g, EngineConfig(
        pair_backend="join", push_backend="plain", pair_batch=64,
        source_batch=8, cache_size=0), device=dev)
    err = {"pair": float(np.abs(plain.pairs(pair_u, pair_v) - pairs).max())}
    for (kind, B), outs in got.items():
        for us, out in outs:
            full = plain.single_source(us)
            if kind == "source":
                e = np.abs(full - out).max()
                ok = out.shape == (len(us), g.n) and np.isfinite(out).all()
            else:
                vals, ids = out
                pv, _ = plain.topk(us, 10)
                e = max(np.abs(pv - vals).max(), np.abs(
                    full[np.arange(len(us))[:, None], ids] - vals).max())
                ok = bool((np.diff(vals, axis=1) <= 0).all())
            if not ok:
                raise RuntimeError(f"{kind} B={B} answers are malformed")
            err[f"{kind} B={B}"] = max(err.get(f"{kind} B={B}", 0.0),
                                       float(e))
    print(f"[scale] kernels vs plain backends on the card: {err} "
          f"(BACKEND_ATOL {TOL_KERNEL}); pairs in [{pairs.min():.4g}, "
          f"{pairs.max():.4g}]")
    if max(err.values()) > TOL_KERNEL or not (0 <= pairs.min()
                                              <= pairs.max() <= 1):
        raise RuntimeError(f"the scale path's answers disagree: {err}")
    del plain, engines[2]
    if profile:
        profile_sparse_build(g, p, dev)
    return launches, (g, p, engines[8])


def options_phase(g, idx, dev, tmp) -> dict:
    """Phase 3e's second part, the build options on phase 3's graph:
    ``build_hp_table`` with ``spill_dir`` and a ``width`` 64 above the
    table's, held against phase 3's in-memory table (equal, the extra
    columns PAD). The counters are zeroed before and read after the
    build. Returns its launches."""
    import os

    import torch

    from repro_torch.core import hp_index
    from repro_torch.kernels.spmv_ell import spmm

    p, hp = idx.plan, idx.hp
    spill = os.path.join(tmp, "spill")
    spmm.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    wide = hp_index.build_hp_table(g, p.theta, p.sqrt_c, p.l_max,
                                   block=BLOCK, width=hp.width + 64,
                                   spill_dir=spill, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    launches = {"spmm": spmm.launches}
    W = hp.width
    files = os.listdir(spill)
    spilled = sum(os.path.getsize(os.path.join(spill, f)) for f in files)
    ok = {"width": wide.width == W + 64,
          "keys": torch.equal(wide.keys[:, :W], hp.keys),
          "vals": torch.equal(wide.vals[:, :W], hp.vals),
          "counts": torch.equal(wide.counts, hp.counts),
          "pad": bool((wide.keys[:, W:] == hp_index.INT32_PAD_KEY).all()
                      and (wide.vals[:, W:] == 0).all())}
    print(f"[options] build_hp_table(width={W + 64}, spill_dir) on "
          f"{g.n:,} nodes: {t:.2f}s, {len(files)} spill files, "
          f"{spilled:,} bytes; launches {launches}; equal to the "
          f"in-memory table with the extra columns PAD: {ok}")
    if not all(ok.values()) or launches["spmm"] <= 0:
        raise RuntimeError(f"the spilled, widened build failed: {ok}, "
                           f"{launches}")
    return launches


class SweepClock:
    """Host seconds of each tile and of each checkpoint write of the join
    sweeps run inside the ``with`` block (``tiles``, ``ckpt``): it wraps
    ``join.sweep._tile_runner`` and ``_save_checkpoint``. A tile ends in
    the copy of its (tile, kq) result to the host, so its host time is
    its device time plus the host's share."""

    def __enter__(self):
        from repro_torch.join import sweep
        self.tiles, self.ckpt = [], []
        self._orig = (sweep._tile_runner, sweep._save_checkpoint)
        runner, save = self._orig

        def tile_runner(*args, **kw):
            run = runner(*args, **kw)

            def run_tile(us):
                t = time.perf_counter()
                out = run(us)
                self.tiles.append(time.perf_counter() - t)
                return out
            return run_tile

        def save_checkpoint(*args, **kw):
            t = time.perf_counter()
            save(*args, **kw)
            self.ckpt.append(time.perf_counter() - t)

        sweep._tile_runner, sweep._save_checkpoint = (tile_runner,
                                                      save_checkpoint)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.join import sweep
        sweep._tile_runner, sweep._save_checkpoint = self._orig


def same_knn(a, b) -> bool:
    """Two KnnGraphs with equal bits in every array."""
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("sources", "indptr", "nbr_ids", "nbr_scores"))


def knn_rows(knn, us):
    """The stored (ids, scores) rows of ``us``, stacked."""
    import numpy as np
    rows = [knn.neighbors(int(u)) for u in us]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


def topk_agreement(idx, g, us, ids_a, sc_a, ids_b, sc_b, dev) -> dict:
    """Two top-k answers for the rows ``us``: the largest score
    difference position by position, and the largest gap between the
    scores of two different ids at one position, the scores read from
    the kernel's single-source rows on the card (64 rows at a time, on
    the device). ids agree outside near-ties when the gap is <= 1e-5."""
    import numpy as np
    import torch

    from repro_torch.core import device_state
    from repro_torch.core.single_source import batched_single_source
    st = device_state.serving_arrays(idx, g, dev)
    gap = 0.0
    for lo in range(0, len(us), 64):
        u = torch.as_tensor(np.asarray(us[lo:lo + 64], np.int64),
                            device=dev)
        full = batched_single_source(st.keys, st.vals, st.d, st.layout, u,
                                     st.tau, n=idx.n, l_max=idx.plan.l_max,
                                     backend="kernel")
        a = torch.as_tensor(ids_a[lo:lo + 64], device=dev).long()
        b = torch.as_tensor(ids_b[lo:lo + 64], device=dev).long()
        d = (full.gather(1, a) - full.gather(1, b)).abs()
        gap = max(gap, float(d.max()))
        del full
    return {"scores": float(np.abs(sc_a - sc_b).max()), "id_gap": gap,
            "ids_differ": int((ids_a != ids_b).sum())}


def subset_4096(g):
    """Phase 3f's seeded 4,096-source subset (sorted)."""
    import numpy as np
    return np.sort(np.random.default_rng(3).choice(
        g.n, min(4096, g.n), replace=False))


def join_sweeps(idx, g, dev, tmp, label: str, sources, stop: int,
                every: int, threshold: bool):
    """The sweeps of phase 3f on one index, inside the launch count:
    the top-k sweep (k = 16, tile = 64) of ``sources`` (None: all n),
    with ``threshold`` a threshold sweep (tau the median 16th score,
    cap 256) of a seeded 4,096-source subset, then the top-k sweep again
    with a checkpoint every ``every`` tiles, stopped after ``stop``
    tiles and resumed. Returns (the uninterrupted artifact, the tiles
    computed, the printed facts); the artifact is saved to ``tmp`` and
    loaded back, and the loaded one returned."""
    import os

    import numpy as np
    import torch

    from repro_torch.device import synchronize
    from repro_torch.join import JoinConfig, KnnGraph, run_join

    n_src = g.n if sources is None else len(sources)
    tiles = -(-n_src // 64)
    facts = {}
    with SweepClock() as clock:
        synchronize(dev)
        t0 = time.perf_counter()
        knn = run_join(idx, g, sources, JoinConfig(k=16, tile=64),
                       device=dev)
        wall = time.perf_counter() - t0
    facts["sweep"] = (f"{n_src:,} sources in {tiles} tiles of 64: "
                      f"{wall:.3f} s, {n_src / wall:,.0f} sources/s, per "
                      f"tile {pct(clock.tiles)}, nnz {knn.nnz:,}")
    computed = tiles
    if threshold:
        tau = float(np.median(knn.nbr_scores.reshape(-1, 16)[:, 15]))
        sub = subset_4096(g)
        t0 = time.perf_counter()
        thr = run_join(idx, g, sub, JoinConfig(tau=tau, cap=256, tile=64),
                       device=dev)
        wall_t = time.perf_counter() - t0
        computed += -(-len(sub) // 64)
        lens = np.diff(thr.indptr)
        facts["threshold"] = (
            f"tau {tau:.6g} (median 16th score), cap 256, {len(sub):,} "
            f"sources: "
            f"{wall_t:.3f} s, nnz {thr.nnz:,}, row length min/median/max "
            f"{lens.min()}/{int(np.median(lens))}/{lens.max()}, truncated "
            f"{int(thr.truncated.sum())}")
        if not (thr.mode == "threshold" and (thr.nbr_scores >= tau).all()):
            raise RuntimeError("the threshold sweep kept a score below tau")
    ck = os.path.join(tmp, f"{label}.ckpt.npz")
    cfg = JoinConfig(k=16, tile=64, checkpoint_path=ck,
                     checkpoint_every=every)
    with SweepClock() as ck_clock:
        if run_join(idx, g, sources, cfg, stop_after_tiles=stop,
                    device=dev) is not None:
            raise RuntimeError("a stopped sweep returned an artifact")
        ck_bytes = os.path.getsize(ck)
        resumed = run_join(idx, g, sources, cfg, device=dev)
    computed += tiles
    equal = same_knn(resumed, knn)
    facts["resume"] = (
        f"stopped after {stop} tiles ({ck_bytes:,}-byte checkpoint), "
        f"resumed for {len(ck_clock.tiles) - stop}: equal bits to the "
        f"uninterrupted sweep {equal}; {len(ck_clock.ckpt)} checkpoint "
        f"writes, ms " + "/".join(f"{1e3 * t:.1f}" for t in ck_clock.ckpt)
        + f"; checkpoint removed {not os.path.exists(ck)}")
    if not equal or os.path.exists(ck) \
            or len(ck_clock.tiles) != tiles:
        raise RuntimeError(f"{label}: the resumed sweep differs from the "
                           "uninterrupted one")
    path = os.path.join(tmp, f"{label}.knn.npz")
    t0 = time.perf_counter()
    knn.save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = KnnGraph.load(path)
    t_load = time.perf_counter() - t0
    facts["artifact"] = (f"nbytes {knn.nbytes():,}, file "
                         f"{os.path.getsize(path):,} bytes, save "
                         f"{t_save * 1e3:.1f} ms, load {t_load * 1e3:.1f} ms,"
                         f" equal bits {same_knn(back, knn)}")
    if not same_knn(back, knn):
        raise RuntimeError(f"{label}: the artifact's round trip changed it")
    facts["peak"] = torch.cuda.max_memory_allocated() / 2**30
    return back, computed, facts


def tile_split(idx, g, us, dev) -> str:
    """One join tile's device time by part (CUDA events, 20 reps): the
    push of the tile's 64 sources on the kernel, and the stable top-k of
    its (64, n) slab; outside the launch count."""
    import torch

    from repro_torch.core import device_state
    from repro_torch.core.single_source import batched_single_source
    from repro_torch.core.topk import stable_topk
    st = device_state.serving_arrays(idx, g, dev)
    u = torch.as_tensor(us[:64].astype("int64"), device=dev)

    def push():
        return batched_single_source(st.keys, st.vals, st.d, st.layout, u,
                                     st.tau, n=idx.n, l_max=idx.plan.l_max,
                                     backend="kernel")
    slab = push()
    t_push = time_ms(push, 20)
    t_topk = time_ms(lambda: stable_topk(slab, 16), 20)
    return (f"a tile's parts on the card (CUDA events): push (B = 64) "
            f"{t_push:.4f} ms, stable top-16 of the (64, {idx.n:,}) slab "
            f"{t_topk:.4f} ms")


def join_checks(idx, g, knn, eng, us, dev) -> dict:
    """Phase 3f's checks, outside the count: the artifact's rows of
    ``us`` against ``eng.topk(us, 16)`` and against a sweep of ``us`` on
    the plain push on the card."""
    from repro_torch.join import JoinConfig, run_join

    ki, ks = knn_rows(knn, us)
    ev, ei = eng.topk(us, 16)
    plain = run_join(idx, g, us, JoinConfig(k=16, tile=64,
                                            push_backend="plain"),
                     device=dev)
    pi, ps = knn_rows(plain, us)
    out = {"engine": topk_agreement(idx, g, us, ki, ks, ei, ev, dev),
           "plain": topk_agreement(idx, g, us, ki, ks, pi, ps, dev)}
    if any(v["scores"] > TOL_KERNEL or v["id_gap"] > 1e-5
           for v in out.values()):
        raise RuntimeError(f"the join disagrees: {out}")
    return out


def join_phase(g, idx, eng, scale, dev, tmp, v3_path):
    """Phase 3f, the bulk join (see the module docstring): at the Enron
    regime on phase 3's index and engine, then on phase 3e's mapped
    10^6-node index. The counters are zeroed before each part's sweeps
    and read after them; ``horner_push`` must launch once per tile
    computed. Phase 3's engine is swapped back to phase 3's index at the
    end. Returns the launches of both parts, and (sources, ids, scores)
    of the all-sources artifact's rows for the seeded 4,096-source
    subset, which phase 3h sweeps again on a mesh."""
    import numpy as np
    import torch

    from repro_torch.core import build, device_state, update
    from repro_torch.core.index import SlingIndex
    from repro_torch.device import synchronize
    from repro_torch.join import JoinConfig, run_join
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}

    def zero():
        for kern in kernels.values():
            kern.launches = 0
        horner_push_rows.steps = 0
        torch.cuda.reset_peak_memory_stats()

    def read():
        out = {k: kern.launches for k, kern in kernels.items()}
        out["horner_push_steps"] = horner_push_rows.steps
        return out

    rng = np.random.default_rng(6)
    sample = np.sort(rng.choice(g.n, 256, replace=False)).astype(np.int32)

    # ---- Enron: all sources, threshold, stop and resume ---------------
    zero()
    # stop after 100 tiles (Enron's 574), or halfway on a smaller graph
    stop = min(100, -(-g.n // 64) // 2)
    back, tiles, facts = join_sweeps(idx, g, dev, tmp, "enron", None, stop,
                                     64, True)
    eng.attach_knn(back)
    t0 = time.perf_counter()
    served = [eng.knn(int(u)) for u in sample]
    t_knn = (time.perf_counter() - t0) / len(sample)
    lookups_equal = all(
        np.array_equal(ids, back.neighbors(int(u))[0])
        for u, (ids, _) in zip(sample, served))
    # a swap to a repaired copy of the index: lookups refused until a
    # fresh join at the new epoch is attached
    w = SlingIndex.load(v3_path, device=dev)
    m_batch = max(2, int(g.m * CHURN[0]))
    delta = update.random_delta(g, n_add=m_batch // 2,
                                n_del=m_batch - m_batch // 2, seed=17)
    rep = build.update_index(w, g, delta, seed=17)
    eng.swap_index(w, rep.graph, affected=rep.affected)
    refused = []
    try:
        eng.knn(int(sample[0]))
    except RuntimeError:
        refused.append("knn")
    try:
        eng.attach_knn(back)
    except ValueError:
        refused.append("attach")
    fresh = run_join(w, rep.graph, sample, JoinConfig(k=16, tile=64),
                     device=dev)
    tiles += 4
    eng.attach_knn(fresh)
    after = eng.knn(int(sample[0]))
    synchronize(dev)
    launches = read()
    st = eng.stats()
    eng.swap_index(idx, g)     # phase 4 measures phase 3's index
    del w, rep
    print(f"[join] Enron {facts['sweep']}; device peak "
          f"{facts['peak']:.3f} GiB")
    print(f"[join] Enron threshold: {facts['threshold']}")
    print(f"[join] Enron checkpoint: {facts['resume']}")
    print(f"[join] Enron artifact: {facts['artifact']}; attached to "
          f"phase 3's engine, "
          f"knn(u) {t_knn * 1e6:.1f} us a lookup, equal to the rows "
          f"{lookups_equal}; after a swap ({m_batch} edges) refused "
          f"{refused}, a fresh 256-source join at epoch {fresh.epoch} "
          f"served {len(after[0])} ids; stats knn={st['knn']} "
          f"knn_stale_rejects={st['knn_stale_rejects']}; launches "
          f"{launches} for {tiles} tiles")
    if not lookups_equal or refused != ["knn", "attach"] \
            or st["knn_stale_rejects"] != 1:
        raise RuntimeError("the artifact's lookups failed their checks")
    if launches["horner_push"] != tiles:
        raise RuntimeError(f"horner_push launched {launches['horner_push']}"
                           f" times for {tiles} tiles")
    chk = join_checks(idx, g, back, eng, sample, dev)
    print(f"[join] Enron 256 rows vs QueryEngine.topk(u, 16) and vs a "
          f"plain-push sweep on the card: {chk} (BACKEND_ATOL "
          f"{TOL_KERNEL}); {tile_split(idx, g, sample, dev)}; card "
          f"{card_line()}")
    sub = subset_4096(g)
    enron_rows = (sub, *knn_rows(back, sub))
    del back, fresh
    device_state.cache_clear()
    total = launches

    # ---- 10^6: a 4,096-source subset holding the hub -------------------
    g1, _, eng1 = scale
    idx1 = eng1.index
    hub = int(np.argmax(g1.in_deg))
    sub = np.random.default_rng(8).choice(g1.n, 4096, replace=False)
    if hub not in sub:
        sub[0] = hub
    sub = np.sort(sub).astype(np.int32)
    zero()
    knn1, tiles1, facts1 = join_sweeps(idx1, g1, dev, tmp, "scale", sub, 32,
                                       16, False)
    synchronize(dev)
    launches1 = read()
    print(f"[join] 10^6 (mapped prsim file; the full sweep, 15,625 tiles, "
          f"is left out for the smoke's time limit): {facts1['sweep']}; "
          f"hub {hub} among the sources; device peak {facts1['peak']:.3f} "
          f"GiB")
    print(f"[join] 10^6 checkpoint: {facts1['resume']}; artifact "
          f"{facts1['artifact']}; launches {launches1} for {tiles1} tiles")
    if launches1["horner_push"] != tiles1:
        raise RuntimeError(f"horner_push launched "
                           f"{launches1['horner_push']} times for {tiles1} "
                           "tiles at 10^6")
    pick = np.random.default_rng(9).choice(len(sub), 255, replace=False)
    us1 = np.unique(np.append(sub[pick], hub)).astype(np.int32)
    chk1 = join_checks(idx1, g1, knn1, eng1, us1, dev)
    print(f"[join] 10^6 {len(us1)} rows vs QueryEngine.topk(u, 16) and vs "
          f"a plain-push sweep on the card: {chk1}; "
          f"{tile_split(idx1, g1, np.append(hub, us1[us1 != hub]), dev)} "
          f"(the hub in the tile); card "
          f"{card_line()}")
    del knn1
    device_state.cache_clear()
    return {k: total[k] + launches1[k] for k in total}, enron_rows


def frontend_phase(g, v3_path, dev) -> dict:
    """Phase 3g, the serving frontend at the Enron regime (see the module
    docstring). The counters are zeroed before the frontend is made and
    read after its last ``drain``; the checks against direct engines
    run after. Returns the launches of the path."""
    import numpy as np
    import torch

    from repro_torch.core import build, update
    from repro_torch.core.index import SlingIndex
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import (EngineConfig, FrontendConfig,
                                   QueryEngine, ServeFrontend, zipf_nodes)

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    cfg = FrontendConfig(max_batch=8, max_pair_batch=64, max_wait=0.002,
                         default_timeout=0.05, replicas=2,
                         routing="least_loaded", engine=EngineConfig())
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fe = ServeFrontend.from_index_file(v3_path, g, cfg, mmap=True,
                                       device=dev)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    per_replica = (torch.cuda.memory_allocated() - mem0) / cfg.replicas
    warm = fe.warmup()
    shapes0 = set(map(tuple, fe.stats()["unique_shapes"]))
    e0 = fe.stats()["epoch"]

    def traffic(count, seed):
        us = zipf_nodes(g.n, count, s=1.1, seed=seed)
        vs = zipf_nodes(g.n, count, s=1.1, seed=seed + 1)
        made = []
        t = time.perf_counter()
        for i, (u, v) in enumerate(zip(us.tolist(), vs.tolist())):
            kind = ("pair", "source", "topk")[i % 3]
            made.append((kind, u, v, fe.submit_pair(u, v) if kind == "pair"
                         else fe.submit_source(u) if kind == "source"
                         else fe.submit_topk(u, 10)))
        t_submit = time.perf_counter() - t
        fe.flush()
        fe.drain(timeout=600.0)
        return made, t_submit, time.perf_counter() - t

    pre, sub_s, wall = traffic(6000, 0)
    log_pre = len(fe.batch_log)
    w = SlingIndex.load(v3_path, device=dev)
    m_batch = max(2, int(g.m * CHURN[0]))
    delta = update.random_delta(g, n_add=m_batch // 2,
                                n_del=m_batch - m_batch // 2, seed=23)
    t0 = time.perf_counter()
    rep = build.update_index(w, g, delta, seed=23)
    t_upd = time.perf_counter() - t0
    sw = fe.swap_index(w, rep.graph, affected=rep.affected)
    post, sub_s2, wall2 = traffic(500, 2)
    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    st = fe.stats()
    log = list(fe.batch_log)
    fe.close()

    # the audit trail: pure, monotone epochs, no shape growth
    epochs = [r.epoch for r in log]
    e1 = sw["epoch"]
    served_pre = sum(not t.shed for *_, t in pre)
    served_post = sum(not t.shed for *_, t in post)
    ok = {"log_complete": len(log) == st["batches"],
          "epochs": set(epochs) <= {e0, e1} and epochs == sorted(epochs),
          "pre_at_e0": sum(r.size for r in log[:log_pre]
                           if r.epoch == e0) == served_pre,
          "post_at_e1": sum(r.size for r in log if r.epoch == e1)
          == served_post,
          "shapes": set(map(tuple, st["unique_shapes"])) == shapes0,
          "launched": min(launches.values()) > 0,
          "no_failed_batches": st["failed"] == 0}
    # a sample of tickets against direct engines, bit for bit
    direct = {e0: QueryEngine.from_index_file(v3_path, g, EngineConfig(),
                                              mmap=True, device=dev),
              e1: QueryEngine(w, rep.graph, EngineConfig(), device=dev)}
    mism = 0
    checked = 0
    for made, epoch in ((pre, e0), (post, e1)):
        ref = direct[epoch]
        live = [m for m in made if not m[3].shed]
        for kind, u, v, t in live[:: max(1, len(live) // 96)]:
            got = t.result(timeout=60.0)
            if kind == "pair":
                same = got == ref.pair(u, v)
            elif kind == "source":
                same = np.array_equal(got, ref.single_source([u])[0])
            else:
                rv, ri = ref.topk([u], 10)
                same = (np.array_equal(got[0], rv[0])
                        and np.array_equal(got[1], ri[0]))
            mism += not same
            checked += 1
    ok["bitwise"] = mism == 0
    del direct, w, rep

    print(f"[frontend] from_index_file(mmap) with 2 replicas "
          f"{t_make * 1e3:.1f} ms, device bytes a replica "
          f"{per_replica:,.0f}; warmup (max over replicas) "
          + " ".join(f"{k}={v:.3f}s" for k, v in warm.items()))
    print(f"[frontend] 6,000 requests (Zipf 1.1) submitted in "
          f"{sub_s:.3f} s, served in {wall:.3f} s ({6000 / wall:,.0f} "
          f"req/s); update_index ({m_batch} edges) {t_upd:.3f} s, swap "
          f"through the barrier {sw['swap_ms']:.1f} ms (barrier batches "
          f"{sw['barrier_batches']}, recompiles {sw['recompiles']}, "
          f"epoch {e0} -> {e1}); 500 more in {wall2:.3f} s")
    hits, misses = st["cache_hits_by_kind"], st["cache_misses_by_kind"]
    for kind, tag in (("pair", "pair"), ("source", "src"),
                      ("topk", "topk")):
        lat = [t.latency for k, _, _, t in pre + post
               if k == kind and not t.shed]
        shed = sum(t.shed for k, _, _, t in pre + post if k == kind)
        recs = [r for r in log if r.kind == kind]
        fill = (float(np.mean([r.size / r.cap for r in recs]))
                if recs else 0.0)
        h, mi = hits.get(tag, 0), misses.get(tag, 0)
        print(f"[frontend] {kind}: ticket latency {pct(lat)}, shed "
              f"{shed}, batches {len(recs)}, mean fill {fill:.3f}, cache "
              f"hit rate {h / max(1, h + mi):.3f}")
    # a record's ``closed`` is when a worker took the batch up, so
    # closed - opened is the wait from the first admission to dispatch
    waits = {why: [1e3 * (r.closed - r.opened) for r in log
                   if r.reason == why] for why in ("size", "wait", "flush")}
    ages = [1e3 * (t.fulfil_t - t.submit_t) for *_, t in pre + post
            if t.shed]
    print("[frontend] batches by close reason, first admission to "
          "dispatch ms p50/max: " + "; ".join(
              f"{why} {len(w)}" + (f" {np.median(w):.3f}/{max(w):.3f}"
                                   if w else "")
              for why, w in waits.items())
          + f"; shed tickets' age at the shed ms p50/max "
          + (f"{np.median(ages):.3f}/{max(ages):.3f}" if ages else "none")
          + f" (deadline {1e3 * cfg.default_timeout:g} ms)")
    print(f"[frontend] launches {launches}; {checked} tickets vs direct "
          f"engines, {mism} differ; shed {st['shed']} of which failed on "
          f"a worker {st['failed']}; checks {ok}; card {card_line()}")
    if not all(ok.values()):
        raise RuntimeError(f"the frontend failed its checks: {ok}")
    return launches


def id_gap(full, ids_a, ids_b) -> float:
    """The largest gap between the scores (rows of ``full``, host) of two
    top-k answers' ids at one position: ids agree outside near-ties when
    it is <= 1e-5."""
    import numpy as np
    rows = np.arange(len(full))[:, None]
    return float(np.abs(full[rows, ids_a] - full[rows, ids_b]).max())


def sharded_phase(g, idx, eng0, answers, queries, enron_rows, scale, dev,
                  v3_path) -> dict:
    """Phase 3h, node-sharded SLING on the card (see the module
    docstring): every shard on ``dev``, so the slab kernel, the frontier
    exchange and the merges run for real while the exchange stays on one
    card. The counters are zeroed before the mesh build and read after
    the last 10^6 batch; ``horner_push_slabs``, ``spmm`` and
    ``hp_join`` must launch. The checks against phase 3's single-device
    answers and engines run after, and the launches of one sharded push
    (S = 4, B = 8) from a trace of ten. Returns the path's launches."""
    import numpy as np
    import torch

    from repro_torch.core import build, shard_query, update
    from repro_torch.core.index import SlingIndex
    from repro_torch.core.single_source import (
        batched_single_source_sharded, pod_slabs, prune_tau)
    from repro_torch.device import synchronize
    from repro_torch.join import JoinConfig, run_join
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_slabs)
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import EngineConfig, QueryEngine

    def timed(fn):
        synchronize(dev)
        t = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t

    kernels = {"horner_push_slabs": horner_push_slabs,
               "spmm": spmm, "hp_join": hp_join,
               "horner_push": horner_push_rows}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # ---- the build over a 2-shard mesh ----------------------------------
    mesh2 = make_debug_mesh((2,), ("data",), devices=[dev] * 2)
    built, t_build = timed(lambda: build.build_index(
        g, eps=EPS, c=0.6, seed=0, block=BLOCK, mesh=mesh2))
    same_build = (torch.equal(built.d, idx.d)
                  and torch.equal(built.hp.keys, idx.hp.keys)
                  and torch.equal(built.hp.vals, idx.hp.vals))
    del built
    # ---- serving over 4 shards, a churn batch through the swap ---------
    mesh4 = shard_query.serving_mesh(4, devices=[dev] * 4)
    w = SlingIndex.load(v3_path, device=dev)
    eng = QueryEngine(w, g, EngineConfig(mesh=mesh4), device=dev)
    warm = eng.warmup()
    shapes = eng.stats()["unique_shapes"]
    before, lat = serve_sample(eng, *queries)
    m_batch = max(2, int(g.m * CHURN[0]))
    delta = update.random_delta(g, n_add=m_batch // 2,
                                n_del=m_batch - m_batch // 2, seed=21)
    rep, t_upd = timed(lambda: build.update_index(w, g, delta, seed=21))
    sw = eng.swap_index(w, rep.graph, affected=rep.affected)
    after, lat2 = serve_sample(eng, *queries)
    st = eng.stats()
    # ---- the pod path on a 2 x 2 (data, model) mesh ---------------------
    if g.n % 2:
        raise RuntimeError("the pod path needs an even node count")
    mesh22 = make_debug_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    blk = shard_query.partition_edges(
        g, idx.plan.sqrt_c, 2, g.n // 2,
        shard_query.required_edge_cap(g, 2, g.n // 2))
    pod_us = queries[2][:8]
    # the slabs are built once (timed apart), as a serving loop would
    pod_sl, t_pod_slabs = timed(lambda: pod_slabs(idx.d, *blk, g.n, mesh22))
    batched_single_source_sharded(
        idx.hp.keys, idx.hp.vals, idx.d, *blk, pod_us, prune_tau(idx.plan),
        g.n, idx.plan.l_max, mesh22, slabs=pod_sl)
    pod, t_pod = timed(lambda: batched_single_source_sharded(
        idx.hp.keys, idx.hp.vals, idx.d, *blk, pod_us, prune_tau(idx.plan),
        g.n, idx.plan.l_max, mesh22, slabs=pod_sl).cpu().numpy())
    # ---- the bulk join over 4 shards ------------------------------------
    sub, sub_ids, sub_sc = enron_rows
    knn, t_join = timed(lambda: run_join(
        idx, g, sub, JoinConfig(k=16, tile=64, mesh=mesh4), device=dev))
    # ---- the mapped 10^6 index over 4 shards ----------------------------
    sg, _, seng = scale
    ssi, t_shard = timed(lambda: shard_query.shard_index(seng.index, sg,
                                                         mesh4))
    hub = int(np.argmax(sg.in_deg))
    rng = np.random.default_rng(11)
    big = {}
    for B in (2, 8):
        us = np.r_[hub, rng.choice(sg.n, B - 1, replace=False)].astype(
            np.int32)
        ss, t_ss = timed(lambda: shard_query.sharded_single_source(ssi, us))
        tk, t_tk = timed(lambda: shard_query.sharded_topk(ssi, us, 10))
        big[B] = (us, ss, tk, t_ss, t_tk)
    synchronize(dev)
    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[sharded] build_index(mesh 2 x {dev}) {t_build:.2f}s, d and "
          f"HP table equal to phase 3's bit for bit: {same_build}")
    print(f"[sharded] engine over 4 shards on {dev}: warmup "
          + " ".join(f"{k}={v:.3f}s" for k, v in warm.items())
          + "; before the swap " + "; ".join(
              f"{k} {pct(v)}" for k, v in lat.items())
          + f"; update_index ({m_batch} edges) {t_upd:.2f}s, swap "
          f"{sw['swap_ms']:.1f} ms, recompiles {sw['recompiles']}; after "
          + "; ".join(f"{k} {pct(v)}" for k, v in lat2.items())
          + f"; nbytes_per_shard {eng._sharded.nbytes_per_shard():,}, "
          f"edge_cap {eng._sharded.edge_cap}, width_cap "
          f"{eng._sharded.width_cap}")
    print(f"[sharded] pod path 2 x 2 (data, model), B = 8: {t_pod * 1e3:.2f}"
          f" ms a push (its slabs built once in {t_pod_slabs * 1e3:.2f} ms)"
          f"; join over 4 shards: {len(sub):,} sources in "
          f"{-(-len(sub) // 64)} tiles, {t_join:.3f}s "
          f"({len(sub) / t_join:,.0f} sources/s)")
    print(f"[sharded] 10^6 mapped index over 4 shards: shard_index "
          f"{t_shard:.2f}s, nbytes_per_shard {ssi.nbytes_per_shard():,}; "
          + "; ".join(f"B={B} (hub {hub} in the batch) single-source "
                      f"{v[3] * 1e3:.2f} ms, top-10 {v[4] * 1e3:.2f} ms"
                      for B, v in big.items()))
    print(f"[sharded] launches {launches}; phase {wall:.1f}s; device peak "
          f"{peak:.3f} GiB; card {card_line()}")
    if not same_build:
        raise RuntimeError("the mesh build differs from phase 3's")
    for k in ("horner_push_slabs", "spmm", "hp_join"):
        if launches[k] <= 0:
            raise RuntimeError(f"{k} did not launch on the sharded path: "
                               f"{launches}")
    if st["unique_shapes"] != shapes or st["swap_recompiles"] != 0 \
            or st["mesh_shards"] != 4 or st["push_backend"] != "kernel":
        raise RuntimeError(f"the sharded engine grew a shape or did not "
                           f"shard: {st}")

    # checks, outside the count
    err = answer_diff(before, answers)
    ref = answer_arrays(answers)
    got = answer_arrays(before)
    err["topk_id_gap"] = id_gap(eng0.single_source(queries[3]),
                                got["topk_ids"], ref["topk_ids"])
    one = QueryEngine(w, rep.graph, EngineConfig(), device=dev)
    want, _ = serve_sample(one, *queries)
    err_after = answer_diff(after, want)
    err_after["topk_id_gap"] = id_gap(
        one.single_source(queries[3]), answer_arrays(after)["topk_ids"],
        answer_arrays(want)["topk_ids"])
    err_pod = float(np.abs(pod - answers["source"][0]).max())
    join_chk = topk_agreement(idx, g, sub, knn_rows(knn, sub)[0],
                              knn_rows(knn, sub)[1], sub_ids, sub_sc, dev)
    err_big = {}
    for B, (us, ss, (tv, tid), _, _) in big.items():
        full = seng.single_source(us)
        ev, ei = seng.topk(us, 10)
        err_big[B] = {"source": float(np.abs(ss - full).max()),
                      "topk": float(np.abs(tv - ev).max()),
                      "topk_id_gap": id_gap(full, tid, ei)}
    print(f"[sharded] vs phase 3's engine: {err}; after the swap vs a "
          f"one-device engine on the repaired index: {err_after}; pod "
          f"path vs phase 3: {err_pod:.3g}; join rows vs phase 3f's: "
          f"{join_chk} (mesh_shards {knn.mesh_shards}); 10^6 vs phase "
          f"3e's engine: {err_big} (BACKEND_ATOL {TOL_KERNEL})")
    worst = max([*err.values(), *err_after.values(), err_pod,
                 join_chk["scores"], join_chk["id_gap"],
                 *(v for e in err_big.values() for v in e.values())])
    if not worst <= TOL_KERNEL or knn.mesh_shards != 4:
        raise RuntimeError("the sharded answers disagree with the "
                           "single-device ones")
    push_us = queries[2][:8]

    def push():
        return shard_query.sharded_scores(eng._sharded, push_us)

    census = launch_census(push, 10)
    before = horner_push_slabs.launches
    for _ in range(10):
        push()
    print(f"[sharded] one sharded push (S = 4 on {dev}, B = 8; trace of "
          f"ten): {(horner_push_slabs.launches - before) / 10:g} "
          f"horner_push_slabs launches by the counter, "
          f"{census['kernels']:g} kernels seen by the profiler and "
          f"{census['host']:g} host launches a push ({census['by_name']}); "
          f"wall {census['wall_ms']:.4f} ms a push, device busy "
          f"{census['busy_ms']:.4f} ms ({census['busy_pct']:.1f}%)")
    del eng, one, ssi, knn, w
    return launches


def slab_row(g, idx, eng, nodes, launches: int, dev) -> dict:
    """``horner_push_slabs`` at the Enron regime, S = 4 shards on the
    card, B = 8 (phase 3's single-source batch): one whole sharded push
    -- every level over every slab in one launch, the rows read through
    the ids from the shards' tables -- against its plain version on the
    same inputs, with two launches held to equal bits, and two checks on
    the card: (a) the levels launched one at a time (ranges of one
    sharing the frontier) equal the one launch bit for bit; (b) a mesh of
    two shards on the card and two on the CPU, the route of several
    devices with the frontier exchanged between levels, within
    TOL_KERNEL of it, and its top-k at k = 10 and k = n_loc + 5 -- the
    merge of each slab's candidates that a mesh of several cards takes,
    here on the card's and the CPU's slabs -- within TOL_KERNEL of the
    one-device top-k, ids equal outside near-ties. Timed: the kernel by the profiler's device time
    (``ms``) and back to back (``call_ms``), the whole sharded push from
    host ids (``push_ms``, and its launches from a trace of ten), the
    plain version, ``torch.sparse.mm`` of every slab's pull for each
    level that runs, and the persistent single-device push. The bound
    counts the whole push's bytes once: the ids, the B rows' live
    entries (key, value and d at the target), every slab's CSR and the
    (n_pad, B) result."""
    import numpy as np
    import torch

    from repro_torch.core import shard_query
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_slabs,
                                                 horner_push_slabs_plain,
                                                 slabs_grid, top_level,
                                                 workspace_numel)
    from repro_torch.kernels.horner_push.horner_push import horner_push_cost
    S, B = 4, 8
    si = shard_query.shard_index(idx, g, shard_query.serving_mesh(
        S, devices=[dev] * S))
    host_us = nodes[512:512 + B].astype(np.int64)
    us = torch.as_tensor(host_us, device=dev)
    rows = [(k, v, s * si.n_loc)
            for s, (k, v) in enumerate(zip(si.keys, si.vals))]
    n_rows = si.n_pad
    kw = dict(n=g.n, l_max=si.l_max, n_rows=n_rows)

    def buffers():
        full = torch.empty((n_rows, B), dtype=torch.float32, device=dev)
        ws = torch.empty(workspace_numel(n_rows, B, si.l_max),
                         dtype=torch.float32, device=dev)
        return full, [full[sl.start:sl.start + sl.layout.n]
                      for sl in si.slabs], ws

    full_k, outs_k, ws_k = buffers()
    full_p, outs_p, ws_p = buffers()

    def kernel():
        horner_push_slabs(rows, us, si.slabs, outs_k, si.tau,
                          workspace=ws_k, **kw)
        return full_k

    def plain():
        horner_push_slabs_plain(rows, us, si.slabs, outs_p, si.tau,
                                workspace=ws_p, **kw)
        return full_p

    got = kernel().clone()
    err = float((got - plain()).abs().max())
    if not torch.equal(got, kernel()):
        raise RuntimeError("two horner_push_slabs launches differ")
    # (a) the levels one at a time
    full_l, outs_l, ws_l = buffers()
    ws_l.fill_(float("nan"))
    for level in range(si.l_max, -1, -1):
        horner_push_slabs(rows, us, si.slabs, outs_l, si.tau, hi=level,
                          lo=level, workspace=ws_l, **kw)
    levels_equal = torch.equal(full_l, got)
    keys_e, vals_e, d_e, lay_e, tau_e = push_inputs(eng)

    def persistent():
        return horner_push_rows(keys_e, vals_e, d_e, us, lay_e, tau_e,
                                l_max=si.l_max)

    push_err = float((got[:g.n].t() - persistent()).abs().max())
    # (b) two shards on the card, two on the CPU
    mixed = shard_query.shard_index(idx, g, shard_query.serving_mesh(
        S, devices=[dev, dev, "cpu", "cpu"]))
    before = horner_push_slabs.launches
    mixed_got = shard_query.sharded_single_source(mixed, host_us)
    mixed_launches = horner_push_slabs.launches - before
    one_launch = got[:g.n].t().cpu().numpy()
    mixed_err = float(np.abs(mixed_got - one_launch).max())
    mixed_topk = {}
    for k in (10, si.n_loc + 5):
        mv, mi = shard_query.sharded_topk(mixed, host_us, k)
        ov, oi = shard_query.sharded_topk(si, host_us, k)
        mixed_topk[k] = (float(np.abs(mv - ov).max()),
                         id_gap(one_launch, mi, oi))
    del mixed

    def sharded_push():
        return shard_query.sharded_scores(si, host_us, "kernel")

    census = launch_census(sharded_push, 10)
    before = horner_push_slabs.launches
    for _ in range(10):
        sharded_push()
    per_push = (horner_push_slabs.launches - before) / 10
    top = top_level(shard_query._query_rows(si, us)[0], g.n, si.l_max)
    levels_run = max(top, 0) + 1
    cnt = idx.hp.counts.to(dev).long()
    live = int(cnt[us].sum())
    m_all = sum(sl.layout.in_idx.numel() for sl in si.slabs)
    cost = horner_push_cost(B, live, m_all,
                            sum(sl.layout.n + 1 for sl in si.slabs), n_rows,
                            levels_run, us.element_size())
    b_ms, b_by = cost.bound_ms()
    print(f"[kernel] horner_push_slabs cost inputs: B={B} live={live} "
          f"edges={m_all} levels_run={levels_run} n_rows={n_rows}")
    mats = []
    for sl in si.slabs:
        lay = sl.layout
        with warnings.catch_warnings():   # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            mats.append(torch.sparse_csr_tensor(
                lay.in_ptr.long(), lay.in_idx.long(), lay.w,
                size=(lay.n, n_rows), check_invariants=False))
    xp = torch.rand((n_rows, B), device=dev)

    def library():
        for _ in range(levels_run):
            for a in mats:
                torch.sparse.mm(a, xp)

    row = {"name": "horner_push_slabs", "route": "cuda",
           "source": "src/repro_torch/csrc/horner_push.cu",
           "replaces": "src/repro/kernels/horner_push/horner_push.py:69",
           "launches": launches, "max_abs_err": err,
           "ms": device_ms(sharded_push, "horner_push_kernel", 20),
           "call_ms": time_ms(kernel, 50),
           "plain_ms": time_ms(plain, 10),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(library, 20),
           "levels_run": levels_run,
           "launches_per_push": per_push,
           "host_launches_per_push": census["host"],
           "push_ms": time_ms(sharded_push, 20),
           "push_busy_pct": census["busy_pct"],
           "persistent_push_ms": time_ms(persistent, 50),
           "push_err": push_err, "levels_one_at_a_time_equal": levels_equal,
           "mixed_mesh_err": mixed_err,
           "mixed_mesh_launches": mixed_launches,
           "mixed_mesh_topk": {str(k): {"err": e, "id_gap": gap}
                               for k, (e, gap) in mixed_topk.items()},
           "shape": f"S={S} B={B} n_loc={si.n_loc} W={si.width_cap} "
                    f"{levels_run} of {si.l_max + 1} levels"}
    topk_line = ", ".join(f"k={k}: err {e:.3g}, id gap {gap:.3g}"
                          for k, (e, gap) in mixed_topk.items())
    print(f"[kernel] horner_push_slabs S={S} B={B}: {per_push:g} launch a "
          f"sharded push by the counter (grid {slabs_grid(si.slabs, B)} "
          f"blocks of 1,024; {census['kernels']:g} kernels seen "
          f"by the profiler, {census['host']:g} host launches a push from "
          f"a trace of ten, device busy "
          f"{census['busy_pct']:.1f}%); levels one at a time equal bits: "
          f"{levels_equal}; mixed mesh (2 x {dev}, 2 x cpu) "
          f"{mixed_launches} launches, {mixed_err:.3g} from one launch; "
          f"its merged top-k {topk_line}")
    if push_err > TOL_KERNEL:
        raise RuntimeError(f"the sharded push disagrees with the "
                           f"persistent push: {push_err}")
    if per_push != 1:
        raise RuntimeError(f"a sharded push on one card made {per_push} "
                           f"horner_push_slabs launches, not one")
    if not levels_equal:
        raise RuntimeError("horner_push_slabs: the levels launched one at "
                           "a time differ from one launch")
    if not mixed_err <= TOL_KERNEL or mixed_launches != levels_run:
        raise RuntimeError(f"the mixed mesh's push disagrees: err "
                           f"{mixed_err}, {mixed_launches} launches for "
                           f"{levels_run} levels")
    if any(not (e <= TOL_KERNEL and gap <= TOL_KERNEL)
           for e, gap in mixed_topk.values()):
        raise RuntimeError(f"the mixed mesh's merged top-k disagrees with "
                           f"the one-device top-k: {mixed_topk}")
    return row


def baselines_phase(dev) -> dict:
    """Phase 3i's first three parts (see the module docstring): SLING
    beside the paper's two competitors on BA(3,000), errors on a
    1,000-node twin against host power, the walk oracles and the
    kernel-level entry points. Returns the launches of the part."""
    import numpy as np
    import torch

    from repro_torch.baselines import linearize, montecarlo, power
    from repro_torch.core import build, walks
    from repro_torch.core.single_source import (single_source_device,
                                                single_source_naive)
    from repro_torch.graph import csr, generators
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.hp_join.ops import (query_pairs_kernel,
                                                 query_pairs_reference)
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.kernels.spmv_ell import ops as spmm_ops

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    t_phase = time.perf_counter()

    def methods(g):
        """SLING, Monte Carlo and Linearize on ``g``, with build seconds."""
        out, secs = {}, {}
        for name, fn in (
                ("sling", lambda: build.build_index(
                    g, eps=BASE_EPS, seed=0, device=dev)),
                ("mc", lambda: montecarlo.build(
                    g, eps=BASE_EPS, seed=0, n_w_override=MC_WALKS,
                    device=dev)),
                ("linearize", lambda: linearize.build(
                    g, R=LIN_R, seed=0, device=dev))):
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        return tuple(out.values()), secs

    # ---- the competitors on BA(3,000) ---------------------------------
    g = generators.barabasi_albert(N_BASE, 4, seed=0, directed=False)
    (idx, mc, lin), secs = methods(g)
    rng = np.random.default_rng(0)
    us = rng.integers(0, g.n, N_PAIR_Q).astype(np.int32)
    vs = rng.integers(0, g.n, N_PAIR_Q).astype(np.int32)
    src = rng.choice(g.n, N_SOURCE_Q, replace=False)
    pair_ms = {
        "sling query_pairs": time_ms(
            lambda: idx.query_pairs(us, vs, device=dev), 5) / N_PAIR_Q,
        "sling query_pairs_kernel": time_ms(
            lambda: query_pairs_kernel(idx, us, vs, device=dev),
            5) / N_PAIR_Q,
        "mc": time_ms(lambda: [montecarlo.query_pair(mc, int(u), int(v))
                               for u, v in zip(us, vs)], 1) / N_PAIR_Q,
        "linearize": time_ms(lambda: [
            linearize.query_pair(lin, g, int(u), int(v))
            for u, v in zip(us, vs)], 1) / N_PAIR_Q}
    source_ms = {
        "sling single_source_device": time_ms(lambda: [
            single_source_device(idx, g, [u], device=dev) for u in src],
            1) / N_SOURCE_Q,
        "single_source_naive": time_ms(lambda: [
            single_source_naive(idx, g, int(u), device=dev) for u in src],
            1) / N_SOURCE_Q,
        "mc": time_ms(lambda: [montecarlo.query_single_source(mc, int(u))
                               for u in src], 1) / N_SOURCE_Q,
        "linearize": time_ms(lambda: [
            linearize.query_single_source(lin, g, int(u)) for u in src],
            1) / N_SOURCE_Q}
    print(f"[baselines] BA({g.n:,}, 4) m={g.m:,}: builds "
          + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items())
          + f"; SLING eps={BASE_EPS} width {idx.hp.width} "
          f"{idx.nbytes():,} bytes; Monte Carlo t={mc.t} n_w={mc.n_w} "
          f"{mc.nbytes():,} bytes; Linearize T={lin.T} R={LIN_R} L=3; "
          f"card {card_line()}")
    print(f"[baselines] per pair query ({N_PAIR_Q} pairs): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in pair_ms.items()))
    print(f"[baselines] per single-source query ({N_SOURCE_Q} sources): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in source_ms.items()))

    # ---- the kernel-level entry points on that index --------------------
    err_join = float(np.abs(query_pairs_kernel(idx, us, vs, device=dev)
                            - query_pairs_reference(idx, us, vs,
                                                    device=dev)).max())
    w = csr.normalized_pull_weights(g, idx.plan.sqrt_c)
    x = torch.rand((g.n, 64), generator=torch.Generator().manual_seed(0))
    err_spmm = float((spmm_ops.spmm(x, g, w, device=dev)
                      - spmm_ops.spmm_reference(x, g, w, device=dev)
                      ).abs().max())
    print(f"[entry] query_pairs_kernel vs query_pairs_reference "
          f"({N_PAIR_Q} pairs): {err_join:.3g}; ops.spmm vs spmm_reference "
          f"((n, 64)): {err_spmm:.3g} (TOL_KERNEL {TOL_KERNEL})")
    if max(err_join, err_spmm) > TOL_KERNEL:
        raise RuntimeError("a kernel-level entry disagrees with its plain "
                           "twin")
    del idx, mc, lin

    # ---- errors on the 1,000-node twin against host power ---------------
    g1 = generators.barabasi_albert(N_TWIN, 4, seed=0, directed=False)
    t0 = time.perf_counter()
    S = power.all_pairs(g1, c=0.6, iters=50)
    t_power = time.perf_counter() - t0
    (idx1, mc1, lin1), _ = methods(g1)
    pu = rng.integers(0, g1.n, N_PAIR_Q)
    pv = rng.integers(0, g1.n, N_PAIR_Q)
    src1 = rng.choice(g1.n, N_SOURCE_Q, replace=False)
    want = S[pu, pv]
    pair_err = {
        "sling": np.abs(idx1.query_pairs(pu, pv, device=dev) - want).max(),
        "mc": max(abs(montecarlo.query_pair(mc1, int(u), int(v)) - s)
                  for u, v, s in zip(pu, pv, want)),
        "linearize": max(abs(linearize.query_pair(lin1, g1, int(u), int(v))
                             - s) for u, v, s in zip(pu, pv, want))}
    off = [np.arange(g1.n) != u for u in src1]
    src_err = {
        "sling": max(np.abs(r - S[u])[o].max() for u, r, o in zip(
            src1, single_source_device(idx1, g1, src1, device=dev), off)),
        "single_source_naive": max(np.abs(single_source_naive(
            idx1, g1, int(u), device=dev) - S[u])[o].max()
            for u, o in zip(src1, off)),
        "mc": max(np.abs(montecarlo.query_single_source(mc1, int(u))
                         - S[u]).max() for u in src1),
        "linearize": max(np.abs(linearize.query_single_source(
            lin1, g1, int(u)) - S[u]).max() for u in src1)}
    margin = linearize.system_matrix_dd_margin(linearize.system_matrix(
        generators.cycle(4), c=0.6, T=60, R=None, device=dev))
    print(f"[baselines] twin BA({g1.n:,}, 4): power.all_pairs on the host "
          f"{t_power:.2f}s; max error, {N_PAIR_Q} pairs: "
          + ", ".join(f"{k} {v:.4g}" for k, v in pair_err.items())
          + f"; {N_SOURCE_Q} sources (SLING off the diagonal): "
          + ", ".join(f"{k} {v:.4g}" for k, v in src_err.items())
          + f" (SLING's eps {BASE_EPS}); Linearize's system on cycle(4) "
          f"diagonal-dominance margin {margin:.4g} (Appendix A: < 0)")
    if max(pair_err["sling"], src_err["sling"],
           src_err["single_source_naive"]) > BASE_EPS or margin >= 0:
        raise RuntimeError(f"SLING outside eps, or cycle(4) diagonally "
                           f"dominant: {pair_err} {src_err} {margin}")

    # ---- the walk oracles on the card -----------------------------------
    est = {(u, v): walks.estimate_simrank_by_walks(
        g1, u, v, c=0.6, n_walks=20000, seed=0, device=dev)
        for u, v in ((3, 11), (0, 1), (20, 40))}
    gap = max(abs(e - S[u, v]) for (u, v), e in est.items())
    dg = walks.DeviceGraph.from_graph(g1, device=dev)
    traj = walks.walk_positions(
        dg.in_ptr, dg.in_idx, dg.in_deg, torch.arange(4096, device=dev) %
        g1.n, torch.Generator(device=dev).manual_seed(0), idx1.plan.sqrt_c,
        20)
    stopped = (traj == -1).to(torch.int8)
    stays = bool((stopped[:, 1:] >= stopped[:, :-1]).all())
    # each move a -> b is an in-edge of a: edge (b -> a) is in the graph
    a, b = traj[:, :-1].long(), traj[:, 1:].long()
    moved = b >= 0
    ekey = torch.as_tensor(g1.edge_dst.astype(np.int64) * g1.n
                           + g1.edge_src, device=dev).sort().values
    q = a[moved] * g1.n + b[moved]
    at = torch.searchsorted(ekey, q).clamp_(max=len(ekey) - 1)
    in_nbr = bool((ekey[at] == q).all())
    print(f"[oracles] estimate_simrank_by_walks (20,000 walk pairs) on "
          f"(3, 11), (0, 1), (20, 40): "
          + ", ".join(f"{e:.4f} vs {S[u, v]:.4f}" for (u, v), e in
                      est.items())
          + f"; max gap {gap:.4f} (bound 0.02, tests/test_walks.py:13); "
          f"walk_positions (4,096 walks, 20 steps): a stopped walk stays "
          f"stopped {stays}, {int(moved.sum()):,} steps, each to an "
          f"in-neighbour {in_nbr}")
    if gap >= 0.02 or not stays or not in_nbr:
        raise RuntimeError("a walk oracle failed on the card")

    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    print(f"[baselines] launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def sling_serve_phase(dev, tmp) -> tuple[dict, dict]:
    """Phase 3i's last part, ``sling-serve`` at the config's full size
    (see the module docstring): ``powerlaw_fast(cfg.n, k=cfg.m //
    cfg.n)``, a float32 ``build_index_scale`` at phase 3e's eps, then
    ``sling_serve_step(cfg)`` on ``cfg.batch`` seeded sources, one push
    launch, its result left on the card. Returns the launches of the
    part, the push's row (time, bound, error on its first 8 rows against
    the plain push) and, for phase 3n, the graph and the index's keys,
    values and d on the host."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import base as configs
    from repro_torch.core import build
    from repro_torch.core.index import SlingIndex
    from repro_torch.graph import generators
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_rows_plain,
                                                 level_runs_plain,
                                                 persistent_grid,
                                                 workspace_numel)
    from repro_torch.kernels.horner_push.horner_push import horner_push_cost
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import SpmmLayout, spmm
    from repro_torch.train import steps

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    for kern in kernels.values():
        kern.launches = 0
    horner_push_rows.steps = 0
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get("sling-serve").full()
    t0 = time.perf_counter()
    g = generators.powerlaw_fast(cfg.n, k=cfg.m // cfg.n, seed=0)
    t_gen = time.perf_counter() - t0
    path = str(Path(tmp) / "sling-serve.sling")
    st = build.build_index_scale(g, path, eps=SCALE_EPS, quant_frac=0.0,
                                 quantize=None, device=dev)
    idx = SlingIndex.load(path, device=dev)
    os.remove(path)
    print(f"[sling-serve] {cfg.name}: powerlaw_fast({cfg.n:,}, "
          f"k={cfg.m // cfg.n}, seed=0) in {t_gen:.2f}s: m={g.m:,} (of "
          f"{cfg.m:,} drawn), max in-degree {int(g.in_deg.max()):,}; "
          f"build_index_scale(eps={SCALE_EPS}, float32) -> "
          f"{st['builder']}: d {st['d_wall_s']:.3f}s, hp "
          f"{st['hp_wall_s']:.3f}s, pack {st['pack_wall_s']:.3f}s; "
          f"entries {st['entries']:,}, width {idx.hp.width} (the config's "
          f"hp_width {cfg.hp_width} is for its eps {cfg.eps}), "
          f"{st['bytes']:,} bytes")
    index = {"keys": idx.hp.keys, "vals": idx.vals_f32(), "d": idx.d}
    lay = SpmmLayout.pull(g, cfg.c ** 0.5, dev)
    us = torch.as_tensor(np.random.default_rng(0).choice(
        cfg.n, cfg.batch, replace=False), device=dev)
    step = steps.sling_serve_step(cfg)

    def push():
        return step(index, {"layout": lay}, {"us": us})

    t0 = time.perf_counter()
    out = push()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in kernels.items()}
    launches["horner_push_steps"] = horner_push_rows.steps
    if launches["horner_push"] != 1:
        raise RuntimeError(f"sling_serve_step at B={cfg.batch} was not one "
                           f"push launch: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = out.shape == (cfg.batch, cfg.n) and bool(torch.isfinite(out).all())
    tau = steps._sling_tau(cfg)
    plain = horner_push_rows_plain(index["keys"], index["vals"], index["d"],
                                   us[:8], lay, tau, l_max=cfg.l_max)
    err = float((out[:8] - plain).abs().max())
    top = float(out.max())
    del out, plain
    # the bound: the ids, the B rows' live entries (key, value, d_k) and
    # the CSR read once, the (B, n) result written once; the operations
    # of every level that runs over every edge and column
    live = int(idx.hp.counts.to(dev).long()[us].sum())
    levels_run = max(int(level_runs_plain(index["keys"][us], cfg.n,
                                          cfg.l_max)[1].max()), 0) + 1
    b_ms, b_by = horner_push_cost(cfg.batch, live, g.m, cfg.n + 1, cfg.n,
                                  levels_run, us.element_size()).bound_ms()
    print(f"[sling-serve] horner_push_rows cost inputs: B={cfg.batch} "
          f"live={live} edges={g.m} levels_run={levels_run} n={cfg.n}")
    # the plain push over all B rows, in 8 column batches of 128 (one
    # batch of 1,024 would gather a (m, B) message array of 21.6 GB),
    # and the library call: l_max + 1 levels of torch.sparse.mm on a
    # (n, B) frontier, as horner_push_case times it
    cols = cfg.batch // 8

    def plain_all():
        for lo in range(0, cfg.batch, cols):
            horner_push_rows_plain(index["keys"], index["vals"], index["d"],
                                   us[lo:lo + cols], lay, tau,
                                   l_max=cfg.l_max)

    plain_ms = time_ms(plain_all, 1)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_csr = torch.sparse_csr_tensor(lay.in_ptr.long(), lay.in_idx.long(),
                                        lay.w, size=(cfg.n, cfg.n),
                                        check_invariants=False)
    x = torch.rand((cfg.n, cfg.batch), device=dev)

    def library():
        y = x
        for _ in range(cfg.l_max + 1):
            y = torch.sparse.mm(a_csr, y)
        return y

    library_ms = time_ms(library, 2)
    del x, a_csr
    row = {"B": cfg.batch, "n": cfg.n, "m": g.m, "width": idx.hp.width,
           "levels_run": levels_run, "max_abs_err": err,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "ms": device_ms(push, "horner_push_kernel", 3),
           "push_ms": time_ms(push, 3), "first_call_s": t_first,
           "bound_ms": b_ms, "bound_by": b_by,
           "workspace_gb": workspace_numel(cfg.n, cfg.batch,
                                           cfg.l_max) * 4 / 1e9,
           "device_peak_gib": peak}
    print(f"[sling-serve] sling_serve_step(B={cfg.batch}, l_max="
          f"{cfg.l_max}, tau={tau:.4g}): one push launch ({levels_run} of "
          f"{cfg.l_max + 1} levels run; grid "
          f"{persistent_grid(lay, cfg.batch)} blocks of 1,024); kernel "
          f"{row['ms']:.3f} ms (device time), step {row['push_ms']:.3f} "
          f"ms (CUDA events), first call {t_first:.2f}s; bound "
          f"{b_ms:.4f} ms ({b_by}); the plain push of all {cfg.batch} "
          f"rows (8 batches of {cols}) {plain_ms:.3f} ms; torch.sparse.mm x "
          f"{cfg.l_max + 1} on a ({cfg.n:,}, {cfg.batch}) frontier "
          f"{library_ms:.3f} ms; workspace {row['workspace_gb']:.2f} GB "
          f"+ result {4 * cfg.n * cfg.batch / 1e9:.2f} GB, device peak "
          f"{peak:.2f} GiB; result ({cfg.batch}, {cfg.n:,}) finite {ok}, "
          f"max {top:.4g}, left on the card; first 8 rows vs the plain "
          f"push {err:.3g} (TOL_KERNEL {TOL_KERNEL}); phase "
          f"{time.perf_counter() - t_phase:.1f}s; card {card_line()}")
    if not ok or not err <= TOL_KERNEL:
        raise RuntimeError(f"sling_serve_step at full size: finite {ok}, "
                           f"error {err}")
    host = {"g": g, "keys": index["keys"].cpu(), "vals": index["vals"].cpu(),
            "d": index["d"].cpu()}
    return launches, row, host


def card_sync_mode():
    """A dispatch mode for a call under
    ``torch.cuda.set_sync_debug_mode("error")``: each aten op that the
    card refuses as synchronizing is noted by name (``.ops``) and run
    again with the check off, so the program runs on."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class CardSyncs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            try:
                return func(*args, **kwargs)
            except RuntimeError as e:
                if "synchronizing CUDA operation" not in str(e):
                    raise
                self.ops.append(func.__name__.split(".")[0])
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return func(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("error")
    return CardSyncs()


def card_syncs(fn, args) -> tuple[list, list, int]:
    """(the aten ops the card refuses as synchronizing in one call of
    ``fn(*args)``, the ops the analyzer's recorder notes in it, the sync
    warnings of a second call under the "warn" mode), both calls warm."""
    import torch

    from repro_torch.analysis.jaxpr_passes import record_syncs
    fn(*args)
    torch.cuda.synchronize()
    mode = card_sync_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with record_syncs(args) as rec:
            with mode:
                fn(*args)
    except RuntimeError as e:
        if "synchronizing CUDA operation" not in str(e):
            raise
        raise RuntimeError(f"a sync outside any aten op, which no "
                           f"dispatch mode sees: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warned = sum("synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    return mode.ops, [s.op for s in rec.syncs], warned


def frontier_allocs(fn, args, min_bytes: int) -> tuple[list, dict]:
    """(the sizes of the allocations of at least ``min_bytes`` in one warm
    call of ``fn(*args)``, read from a memory-history snapshot, the port
    kernels' launches in that call)."""
    import torch

    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_slabs)
    from repro_torch.kernels.hp_join import hp_join
    kerns = {"horner_push_rows": horner_push_rows,
             "horner_push_slabs": horner_push_slabs, "hp_join": hp_join}
    out = fn(*args)
    del out
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in kerns.items()}
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        out = fn(*args)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    launched = {k: f.launches - before[k] for k, f in kerns.items()
                if f.launches > before[k]}
    dev = torch.cuda.current_device()
    sizes = [e["size"] for e in snap["device_traces"][dev]
             if e["action"] == "alloc" and e["size"] >= min_bytes]
    return sizes, launched


def analysis_phase(dev, sling_host) -> dict:
    """Phase 3o (see the module docstring): the analyzer's CLI, its
    host-sync findings and its HBM counts, each held against the card.
    Returns the phase's kernel launches."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from repro_torch.analysis import jaxpr_passes as jp
    from repro_torch.analysis import programs
    from repro_torch.configs import base as configs
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_slabs)
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import SpmmLayout
    from repro_torch.train import steps

    t_phase = time.perf_counter()
    kerns = {"hp_join": hp_join, "horner_push": horner_push_rows,
             "horner_push_slabs": horner_push_slabs}
    start = {k: f.launches for k, f in kerns.items()}
    steps0 = horner_push_rows.steps

    # 1. the CLI, on this host, with jax and the reference blocked
    t0 = time.perf_counter()
    blocked = ("import sys; sys.modules['jax'] = None; "
               "sys.modules['repro'] = None; "
               "from repro_torch.analysis.__main__ import main; "
               "sys.exit(main(sys.argv[1:]))")
    cli = subprocess.run(
        [sys.executable, "-c", blocked, "--baseline",
         str(ROOT / "ANALYSIS_BASELINE_TORCH.json")],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=600, cwd=ROOT)
    lines = cli.stdout.strip().splitlines()
    print(f"[analysis] CLI (jax and repro blocked; jax "
          f"{'is' if importlib.util.find_spec('jax') else 'is not'} "
          f"installed on this host) exit {cli.returncode} in "
          f"{time.perf_counter() - t0:.2f}s: "
          f"{lines[-1] if lines else cli.stderr.strip()[-400:]}")
    if cli.returncode != 0 or not lines or \
            "0 new" not in lines[-1] or "0 pass(es) skipped" not in lines[-1]:
        raise RuntimeError(f"the analyzer's CLI failed: {cli.returncode}\n"
                           f"{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")

    # 2. each program's syncs on the card against the pass's
    for spec in programs.build_specs():
        if spec.devices > 1:
            static_at = ["meta:0"] * spec.devices
            card_at = ["cuda:0"] * spec.devices
        else:
            static_at, card_at = None, ["cuda"]
        fn, args = spec.make() if static_at is None else \
            spec.make(static_at)
        _, syncs = jp.run_program(fn, args, walk=False)
        static = sorted({s.op for s in syncs})
        fn, args = spec.make(card_at)
        raised, noted, warned = card_syncs(fn, args)
        del fn, args
        card = sorted(set(raised))
        note = ""
        if spec.devices > 1:
            fn, args = spec.make()
            _, multi = jp.run_program(fn, args, walk=False)
            note = (f"; on one card {card_at} takes the one-device route,"
                    f" the pass's fake mesh {['meta:0', 'meta:1']} the "
                    f"multi-device one, which syncs on "
                    f"{sorted({s.op for s in multi})}")
        print(f"[analysis] {spec.name}: card syncs {card} "
              f"({len(raised)} a call, {warned} warnings under \"warn\"), "
              f"the pass {static} on {static_at or 'its default'}, its "
              f"recorder on the card {sorted(set(noted))}{note}")
        if card != static or sorted(set(noted)) != static or \
                warned != len(raised):
            raise RuntimeError(f"{spec.name}: the card's syncs {raised} "
                               f"({warned} warnings) are not the pass's "
                               f"{static} (its recorder on the card: "
                               f"{noted})")

    # 3. frontier-sized allocations and launches against the pass
    geo = jp.HBM_GEOMETRY
    cfg = configs.get("sling-serve").full()
    g = sling_host["g"]
    keys, vals, d = (sling_host[k].to(dev) for k in ("keys", "vals", "d"))
    lay = SpmmLayout.pull(g, cfg.c ** 0.5, dev)
    us8 = torch.as_tensor(np.random.default_rng(0).choice(g.n, 8,
                                                          replace=False),
                          device=dev)
    tau = steps._sling_tau(cfg)
    failed = []
    for prog, k in (("source", None), ("topk", 16)):
        fn, args = programs.push_program(
            geo["n"], geo["deg"], geo["W"], geo["l_max"], geo["B"],
            "kernel", k, ["cuda"])
        cases = [(f"HBM_GEOMETRY n={geo['n']} B={geo['B']}", geo["n"],
                  geo["B"], fn, args, jp.HBM_BUDGETS[(prog, "kernel")])]
        cases.append((f"phase 3i n={g.n} B=8", g.n, 8,
                       programs.push_fn("kernel", g.n, cfg.l_max, tau, k),
                       (keys, vals, d, lay, us8), None))
        for label, n, B, fn, args, budget in cases:
            walk, _ = jp.run_program(fn, programs.fake_args(args))
            count = jp.frontier_writes(walk.records, B * n // 2)
            calls = walk.kernels
            sizes, launched = frontier_allocs(fn, args, 4 * (B * n // 2))
            print(f"[analysis] hbm {prog}/kernel at {label}: the pass "
                  f"{count} frontier-sized writes (budget {budget}), "
                  f"kernel calls {calls}; the card {len(sizes)} "
                  f"allocations of >= {4 * (B * n // 2):,} bytes "
                  f"{sizes}, launches {launched}")
            if launched != calls or len(sizes) > count:
                failed.append(f"hbm {prog}/kernel at {label}: card "
                              f"allocations {len(sizes)} > the pass's "
                              f"{count}, or launches {launched} != the "
                              f"walk's kernel calls {calls}")
    del keys, vals, d, lay
    if failed:
        raise RuntimeError("; ".join(failed))
    out = {k: f.launches - start[k] for k, f in kerns.items()}
    out["horner_push_steps"] = horner_push_rows.steps - steps0
    print(f"[analysis] phase {time.perf_counter() - t_phase:.1f}s; "
          f"launches {out}; card {card_line()}")
    return out


def update_phase(g, dev) -> dict:
    """The dynamic-graph path on the card at the Enron regime: build
    with ``STALE_FRAC``, warm an engine, then for each churn level in
    ``CHURN`` run ``update_index`` (theta_r = plan.theta), ``swap_index``
    into the warm engine and serve a few batches of each kind. The
    kernels' counters are zeroed before the batches and read after
    them, batch by batch; the checks (a from-scratch rebuild of the
    mutated graph, the affected sets recomputed for the row check) run
    after each batch's count is read.
    Returns the launches of the path."""
    import numpy as np
    import torch

    from repro_torch.core import build, update
    from repro_torch.graph import csr
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    kernels = {"hp_join": hp_join, "horner_push": horner_push_rows,
               "spmm": spmm}
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=EPS, c=0.6, seed=1, block=BLOCK,
                            stale_frac=STALE_FRAC, device=dev)
    t_build = time.perf_counter() - t0
    p = idx.plan
    print(f"[update] build_index stale_frac={STALE_FRAC}: theta="
          f"{p.theta:.6g} eps_stale={p.eps_stale:.6g} l_max={p.l_max} "
          f"total={t_build:.2f}s width={idx.hp.width}")
    eng = QueryEngine(idx, g, EngineConfig(), device=dev)
    eng.warmup()
    shapes = eng.stats()["unique_shapes"]
    rng = np.random.default_rng(1)
    path, g_cur = {k: 0 for k in kernels}, g
    path["horner_push_steps"] = 0
    for i, churn in enumerate(CHURN):
        for kern in kernels.values():
            kern.launches = 0
        horner_push_rows.steps = 0
        q = rng.permutation(g.n)[:128].astype(np.int32)
        eng.pairs(q[:64], q[64:])               # fill the cache
        eng.single_source(q[:8])
        eng.topk(q[8:16], 10)
        m_batch = int(churn * g_cur.m)
        delta = update.random_delta(g_cur, n_add=m_batch // 2,
                                    n_del=m_batch - m_batch // 2,
                                    seed=100 + i)
        before = spmm.launches
        t0 = time.perf_counter()
        rep = build.update_index(idx, g_cur, delta, seed=10 + i,
                                 theta_r=p.theta)
        t_upd = time.perf_counter() - t0
        upd_spmm = spmm.launches - before
        sw = eng.swap_index(idx, rep.graph, affected=rep.affected)
        lat = {"pair": [], "source": [], "topk": []}
        served = {}
        for lo in range(0, 128, 64):
            t = time.perf_counter()
            served.setdefault("pair", []).append(
                eng.pairs(q[lo:lo + 32], q[lo + 32:lo + 64]))
            lat["pair"].append(time.perf_counter() - t)
        for lo in range(16, 32, 8):
            t = time.perf_counter()
            eng.single_source(q[lo:lo + 8])
            lat["source"].append(time.perf_counter() - t)
            t = time.perf_counter()
            eng.topk(q[lo + 16:lo + 24], 10)
            lat["topk"].append(time.perf_counter() - t)
        torch.cuda.synchronize()
        st = eng.stats()
        for k, kern in kernels.items():
            path[k] += kern.launches
        path["horner_push_steps"] += horner_push_rows.steps
        secs = " ".join(f"{k}={v:.3f}s" for k, v in rep.secs.items())
        print(f"[update {i}] churn {churn:.1%}: |delta|={len(delta)} "
              f"|touched|={len(rep.touched)} |R|={rep.rows_repaired} "
              f"|K|={rep.targets_seeded} |D|={rep.d_updated} "
              f"width_grew={rep.width_grew} update={t_upd:.3f}s ({secs}) "
              f"spmm launches={upd_spmm}")
        print(f"[update {i}] stale={rep.stale:.6g} eps_stale="
              f"{rep.eps_stale:.6g} needs_rebuild={rep.needs_rebuild}; swap "
              f"{sw['swap_ms']:.2f} ms, cache dropped {sw['cache_dropped']},"
              f" swap_recompiles={st['swap_recompiles']} (this swap "
              f"{sw['recompiles']}), shapes grew="
              f"{st['unique_shapes'] != shapes}, epoch={sw['epoch']}")
        for kind, ls in lat.items():
            print(f"[update {i}] served {kind}: {len(ls)} batches, "
                  f"per batch {pct(ls)}")
        # checks, outside the path's launch count
        e_pair = float(np.abs(np.concatenate(served["pair"]) - np.concatenate(
            [idx.query_pairs(q[lo:lo + 32], q[lo + 32:lo + 64], dev)
             for lo in (0, 64)])).max())
        g_new, touched, tv = csr.apply_edges(g_cur, delta)
        rows, targets, _, _, _ = update.affected_sets(
            g_cur, g_new, touched, tv, p, p.theta, device=dev)
        t0 = time.perf_counter()
        fresh = build.build_index(g_new, eps=EPS, c=0.6, seed=1,
                                  block=BLOCK, stale_frac=STALE_FRAC,
                                  device=dev)
        t_fresh = time.perf_counter() - t0
        chk = table_rows_vs_fresh(idx.hp, fresh.hp, rows, targets, p.theta)
        print(f"[update {i}] rows R x targets K vs a from-scratch rebuild "
              f"({t_fresh:.2f}s, update {t_upd:.3f}s): {chk}; engine pairs "
              f"vs the index's join: {e_pair:.3g}")
        if len(rows) != rep.rows_repaired or \
                len(targets) != rep.targets_seeded:
            raise RuntimeError("recomputed affected sets differ from the "
                               "update's")
        if not chk["ok"] or e_pair > TOL_KERNEL:
            raise RuntimeError(f"repaired rows disagree with a rebuild: "
                               f"{chk}, pairs {e_pair}")
        if upd_spmm <= 0:
            raise RuntimeError("update_index did not launch spmm")
        if sw["recompiles"] == 0 and st["unique_shapes"] != shapes:
            raise RuntimeError("a swap that fits grew the shape set")
        shapes = st["unique_shapes"]
        del fresh
        g_cur = rep.graph
    if min(path.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the update path: "
                           f"{path}")
    del eng, idx
    return path


def spmm_chain(lay, h, tau: float, steps: int, stop: bool) -> list:
    """The (frontier, live mask) pairs that a block's steps hand ``spmm``,
    made by the plain version: up to ``steps`` propagations of ``h``,
    ending early (``stop``, the build's stop test) once nothing exceeds
    tau."""
    import torch

    from repro_torch.kernels.spmv_ell import segment_live, spmm_plain
    out, live = [], segment_live(h, tau)
    for _ in range(steps):
        out.append((h, live))
        nxt = torch.empty_like(live)
        h = spmm_plain(h, lay, tau=tau, live_out=nxt)
        live = nxt
        if stop and not bool(live.any()):
            break
    return out


def spmm_need(lay, x, live):
    """What one masked step needs (``spmm_cost`` of its live segments:
    128 bytes per live segment of x read once, out written whole, the
    CSR, the mask words read and written; an FMA per column of each
    edge's live source segments), and the live segments."""
    import torch

    from repro_torch.kernels.spmv_ell.spmv_ell import spmm_cost
    n, F = x.shape
    bits = (live.unsqueeze(-1) >> torch.arange(32, device=x.device)) & 1
    per_row = bits.sum(dim=(1, 2))
    segs = int(per_row.sum())
    edge_segs = int(per_row[lay.in_idx.long()].sum())
    return spmm_cost(n, F, lay.in_idx.numel(), segs, edge_segs,
                     live.numel()), segs


def spmm_row(g, p, dev, nodes, launches: int) -> dict:
    """``spmm`` on what the main path hands it, at F = BLOCK: every step
    of one build block (targets 0..BLOCK-1, pull, theta, up to the stop
    test) and all l_max steps of one push mass-scan block (BLOCK seeds
    with weights in (0, 1], the update's theta_r of the stale_frac plan).
    On every step, and on both step-3 frontiers, the kernel as the path
    calls it (tau and the live mask) must equal the kernel dense on the
    pruned x bit for bit, fill live_out with ``segment_live`` of its
    output, and stay within TOL_KERNEL of ``spmm_plain``. Times: the
    step-3 frontiers masked, dense and through ``torch.sparse.mm``, and
    each block's mean per launch beside ``torch.sparse.mm`` on the same
    pruned frontiers. The row's bound is the step-3 pull frontier's data
    bound (:func:`spmm_need`); the dense bound is printed beside it."""
    import numpy as np
    import torch

    from repro_torch.core import theory
    from repro_torch.kernels.spmv_ell import (SpmmLayout, segment_live,
                                              spmm, spmm_plain)
    from repro_torch.kernels.spmv_ell.spmv_ell import spmm_cost

    pull_lay = SpmmLayout.pull(g, p.sqrt_c, dev)
    push_lay = SpmmLayout.push(g, p.sqrt_c, dev)
    theta = float(np.float32(p.theta))
    theta_r = float(np.float32(theory.plan(
        eps=EPS, c=0.6, n=g.n, stale_frac=STALE_FRAC).theta))
    h = torch.zeros((g.n, BLOCK), device=dev)
    h[torch.arange(BLOCK, device=dev), torch.arange(BLOCK, device=dev)] = 1.0
    build_steps = spmm_chain(pull_lay, h, theta, p.l_max, stop=True)
    h = torch.zeros((g.n, BLOCK), device=dev)
    weights = 1.0 - np.random.default_rng(2).random(BLOCK, np.float32)
    h[torch.as_tensor(nodes[:BLOCK], device=dev),
      torch.arange(BLOCK, device=dev)] = torch.as_tensor(weights, device=dev)
    mass_steps = spmm_chain(push_lay, h, theta_r, p.l_max, stop=False)
    del h
    blocks = (("build", pull_lay, theta, build_steps),
              ("mass scan", push_lay, theta_r, mass_steps))
    out = torch.empty((g.n, BLOCK), device=dev)
    live_out = torch.empty_like(build_steps[0][1])

    def masked(x, live, lay, tau):
        return spmm(x, lay, out, tau=tau, live=live, live_out=live_out)

    # checks, step by step
    err = 0.0
    for name, lay, tau, steps in blocks:
        for i, (x, live) in enumerate(steps):
            got = masked(x, live, lay, tau).clone()
            same_mask = torch.equal(live_out, segment_live(got, tau))
            dense = spmm(torch.where(x > tau, x, 0.0), lay)
            e = float((got - spmm_plain(x, lay, tau=tau)).abs().max())
            err = max(err, e)
            if not torch.equal(got, dense) or not same_mask or \
                    not e <= TOL_KERNEL:
                raise RuntimeError(
                    f"spmm {name} step {i}: masked equals dense "
                    f"{torch.equal(got, dense)}, live_out equals "
                    f"segment_live {same_mask}, vs plain {e}")
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = {id(lay): torch.sparse_csr_tensor(
            lay.in_ptr.long(), lay.in_idx.long(), lay.w, size=(g.n, g.n),
            check_invariants=False) for lay in (pull_lay, push_lay)}
    # the step-3 frontiers
    t3 = {}
    for name, lay, tau, steps in blocks:
        x, live = steps[3]
        xp = torch.where(x > tau, x, 0.0)
        need, segs = spmm_need(lay, x, live)
        print(f"[kernel] spmm {name} step-3 cost inputs: n={g.n} F={BLOCK} "
              f"edges={lay.in_idx.numel()} live_segments={segs} "
              f"edge_segments={need.flops / 64:.0f} mask_words="
              f"{live.numel()}")
        t3[name] = {
            "masked": time_ms(lambda: masked(x, live, lay, tau), 200),
            "dense": time_ms(lambda: spmm(xp, lay, out), 200),
            "library": time_ms(lambda: torch.sparse.mm(csr[id(lay)], xp),
                               200),
            "plain": time_ms(lambda: spmm_plain(
                x, lay, tau=tau, live_out=live_out), 20),
            "bound": need.bound_ms(), "segs": segs,
            "nnz": int((xp > 0).sum())}
    # the path's mean per launch, one block of each kind
    means = {}
    for name, lay, tau, steps in blocks:
        pruned = [torch.where(x > tau, x, 0.0) for x, _ in steps]
        k_ms = time_ms(lambda: [masked(x, live, lay, tau)
                                for x, live in steps], 20) / len(steps)
        l_ms = time_ms(lambda: [torch.sparse.mm(csr[id(lay)], xp)
                                for xp in pruned], 20) / len(steps)
        need = [spmm_need(lay, x, live) for x, live in steps]
        b_mean = sum(c.bound_ms()[0] for c, _ in need) / len(need)
        segs = [sg for _, sg in need]
        means[name] = (k_ms, l_ms)
        print(f"[kernel] spmm {name} block ({len(steps)} launches, theta "
              f"{tau:.6g}): mean per launch masked {k_ms:.4f} ms, "
              f"torch.sparse.mm {l_ms:.4f} ms; mean data bound "
              f"{b_mean:.5f} ms; live segments per step {segs} of "
              f"{g.n * BLOCK // 32}")
        del pruned
    dense_ms, _ = spmm_cost(g.n, BLOCK, g.m).bound_ms()
    for name, t in t3.items():
        print(f"[kernel] spmm {name} step-3 frontier: masked {t['masked']:.4f}"
              f" ms, dense {t['dense']:.4f} ms, torch.sparse.mm "
              f"{t['library']:.4f} ms, plain {t['plain']:.4f} ms; data "
              f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}; "
              f"{t['segs']} live segments, {t['nnz']} nonzeros after the "
              f"prune), dense bound {dense_ms:.5f} ms")
    pull, build = t3["build"], means["build"]
    print(f"[kernel] spmm: the row's bound_ms is the step-3 pull frontier's "
          f"data bound; faster than torch.sparse.mm on the step-3 pull "
          f"frontier: {pull['masked'] < pull['library']}, as a mean over "
          f"the build block: {build[0] < build[1]}")
    return {"name": "spmm", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm.cu",
            "replaces": "src/repro/kernels/spmv_ell/spmv_ell.py:47",
            "launches": launches, "max_abs_err": err,
            "ms": pull["masked"], "plain_ms": pull["plain"],
            "bound_ms": pull["bound"][0], "bound_by": pull["bound"][1],
            "library_ms": pull["library"],
            "shape": f"n={g.n} m={g.m} F={BLOCK}, step-3 pull frontier"}


def device_ms(fn, key: str, reps: int) -> float:
    """Mean device milliseconds per launch of the kernel whose name holds
    ``key`` (each caller's ``fn`` launches it once) over ``reps`` calls
    of ``fn``, from torch.profiler's device activity: the kernel alone,
    where back-to-back CUDA events would time the host's dispatch. The
    mean is over the launches the profiler recorded: a window can drop
    some of their activity records though the launches ran (seen at
    n = 10^6, where one record of three came back), and dividing by
    ``reps`` would then read low. A window can also record none of them
    (seen for the 320 ms push at sling-serve, in two windows of three
    and, in another run, in all three): then the time is the CUDA
    events' over ``reps`` calls of ``fn`` (the kernel and whatever else
    ``fn`` launches), and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA and key in r.key]
        us = sum(r.self_device_time_total for r in rows)
        seen = sum(r.count for r in rows)
        if us > 0:
            if seen != reps:
                print(f"[profile] {key}: {seen} activity records for "
                      f"{reps} launches in window {window}; the mean is "
                      f"over the {seen}")
            return us / seen / 1e3
        print(f"[profile] no device time for {key} in profiler window "
              f"{window} of 3")
    ms = time_ms(fn, reps)
    print(f"[profile] {key}: the profiler recorded none of its launches "
          f"in 3 windows; {ms:.4f} ms a call by CUDA events instead")
    return ms


def launch_floor(dev) -> tuple[float, float]:
    """A yardstick that the port does not call: a one-element in-place
    ``add_`` back to back, by CUDA events over 1,000 calls (what the
    host's dispatch allows) and by the profiler (the kernel alone)."""
    import torch
    x = torch.zeros(1, device=dev)
    return (time_ms(lambda: x.add_(1.0), 1000),
            device_ms(lambda: x.add_(1.0), "elementwise", 200))


def hp_join_row(eng, idx, pair_u, pair_v, launches: int) -> dict:
    """``hp_join`` at the engine's pair shapes (B = 256 pairs, K = the
    width bucket) against its plain version, with two calls held to
    equal bits. ``ms`` is the kernel's device time (profiler); the
    wrapper's back-to-back time and the launch floor are beside it. The
    bound counts the live entries of both rows of each pair, read once,
    and the ids and scores."""
    import torch

    from repro_torch.kernels.hp_join import hp_join, hp_join_plain
    from repro_torch.kernels.hp_join.hp_join import hp_join_cost
    dev = eng.device
    K = eng._width_cap
    us = torch.as_tensor(pair_u, device=dev)
    vs = torch.as_tensor(pair_v, device=dev)
    fk, fv = eng._keys, eng._folded_vals
    got = hp_join(fk, fv, us, vs)
    e_join = float((got - hp_join_plain(fk, fv, us, vs)).abs().max())
    if not torch.equal(got, hp_join(fk, fv, us, vs)):
        raise RuntimeError("two hp_join calls on the same inputs differ")
    cnt = idx.hp.counts.long()
    live_u, live_v = int(cnt[us.long()].sum()), int(cnt[vs.long()].sum())
    b_ms, b_by = hp_join_cost(len(us), live_u, live_v, K).bound_ms()
    print(f"[kernel] hp_join cost inputs: pairs={len(us)} live_u={live_u} "
          f"live_v={live_v} width={K}")
    floor_ms, floor_dev_ms = launch_floor(dev)
    row = {"name": "hp_join", "route": "cuda",
           "source": "src/repro_torch/csrc/hp_join.cu",
           "replaces": "src/repro/kernels/hp_join/hp_join.py:42",
           "launches": launches, "max_abs_err": e_join,
           "ms": device_ms(lambda: hp_join(fk, fv, us, vs),
                           "hp_join_kernel", 200),
           "plain_ms": time_ms(lambda: hp_join_plain(fk, fv, us, vs), 20),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "call_ms": time_ms(lambda: hp_join(fk, fv, us, vs), 200),
           "launch_floor_ms": floor_ms,
           "launch_floor_device_ms": floor_dev_ms,
           "shape": f"B={len(us)} K={K}"}
    print(f"[kernel] hp_join B={len(us)} K={K}: one block a pair; kernel "
          f"{row['ms']:.4f} ms (device time); call {row['call_ms']:.4f} ms "
          f"(CUDA events, back to back); launch_floor_ms "
          f"{floor_ms:.4f} (device {floor_dev_ms:.4f}); plain "
          f"{row['plain_ms']:.4f} ms; bound {b_ms:.5f} ms ({b_by}); "
          f"max_abs_err {e_join:.3g}; two calls equal bits")
    return row


def push_inputs(eng):
    """The engine's push inputs: the padded table, d, Â's layout, tau."""
    return eng._keys, eng._vals, eng._d, eng._layout, eng._tau


def horner_push_case(g, p, eng, sources) -> dict:
    """``horner_push`` on the engine's packed table for the rows
    ``sources`` (one batch) against the plain push on the card: error,
    equal bits from two pushes, the levels the kernel runs (from the
    plain level runs, outside the timed calls), and times: the whole
    push from the row ids on the card to the (B, n) result (CUDA events,
    back to back), the kernel alone (device time), the allocations that
    precede its launch, the plain push and ``torch.sparse.mm`` for all
    l_max + 1 levels. The bound counts each input byte once and the
    result once; ``streamed_bound_ms`` counts what the levels that ran
    stream: the CSR and a frontier read and written a level."""
    import torch

    from repro_torch.kernels.cost import KernelCost
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 horner_push_rows_plain,
                                                 level_runs_plain,
                                                 workspace_numel)
    from repro_torch.kernels.horner_push.horner_push import horner_push_cost
    keys, vals, d, lay, tau = push_inputs(eng)
    dev = keys.device
    n, L = g.n, p.l_max
    us = torch.as_tensor(sources, dtype=torch.long, device=dev)
    B = len(us)

    def push():
        return horner_push_rows(keys, vals, d, us, lay, tau, l_max=L)

    def plain():
        return horner_push_rows_plain(keys, vals, d, us, lay, tau, l_max=L)

    got = push()
    err = float((got - plain()).abs().max())
    if not torch.equal(got, push()):
        raise RuntimeError(f"two pushes of B={B} on the same inputs differ")
    levels_run = max(int(level_runs_plain(keys[us], n, L)[1].max()), 0) + 1

    def allocations():
        return (torch.empty((B, n), dtype=torch.float32, device=dev),
                torch.empty(workspace_numel(n, B, L), dtype=torch.float32,
                            device=dev))

    reps = 1000
    allocations()
    t0 = time.perf_counter()
    for _ in range(reps):
        allocations()
    alloc_ms = (time.perf_counter() - t0) / reps * 1e3
    live = int(eng.index.hp.counts.to(dev).long()[us].sum())
    # inputs once: the ids, the live entries of the B rows (key, value
    # and d_k), the CSR; the (B, n) result once
    cost = horner_push_cost(B, live, g.m, n + 1, n, levels_run,
                            us.element_size())
    b_ms, b_by = cost.bound_ms()
    print(f"[kernel] horner_push_rows cost inputs: B={B} live={live} "
          f"edges={g.m} levels_run={levels_run} n={n}")
    # what the levels that run stream: the CSR and a frontier read and
    # written a level
    streamed, _ = KernelCost(
        levels_run * (8 * g.m + 4 * (n + 1) + 2 * 4 * n * B) + 12 * live,
        cost.flops).bound_ms()
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_csr = torch.sparse_csr_tensor(lay.in_ptr.long(),
                                        lay.in_idx.long(), lay.w,
                                        size=(n, n), check_invariants=False)
    x = torch.rand((n, B), device=dev)

    def library():
        y = x
        for _ in range(L + 1):
            y = torch.sparse.mm(a_csr, y)
        return y

    return {"B": B, "max_abs_err": err, "levels_run": levels_run,
            "ms": device_ms(push, "horner_push_kernel", 50),
            "push_ms": time_ms(push, 50), "alloc_ms": alloc_ms,
            "plain_ms": time_ms(plain, 10), "bound_ms": b_ms,
            "bound_by": b_by, "streamed_bound_ms": streamed,
            "library_ms": time_ms(library, 20),
            "parts": horner_push_parts(g, p, eng, us)}


def horner_push_parts(g, p, eng, us) -> dict:
    """Where the kernel's time goes, timed in this call (device time per
    push) on the same B rows: over the graph with no edge (the launch,
    the prologue, the barriers, the seeds and the units' bookkeeping),
    and over the rows cut to their level-0 keys (one level: the launch,
    the prologue and a level of seeds alone)."""
    import numpy as np
    import torch

    from repro_torch.core.hp_index import INT32_PAD_KEY
    from repro_torch.kernels.horner_push import (horner_push_rows,
                                                 level_runs_plain)
    from repro_torch.kernels.spmv_ell import SpmmLayout
    keys, vals, d, lay, tau = push_inputs(eng)
    dev = keys.device
    n, L = g.n, p.l_max
    none = np.zeros(0, np.int64)
    bare = SpmmLayout.from_edges(none, none, none, n, dev)
    rows_k, rows_v = keys[us].contiguous(), vals[us].contiguous()
    k0 = torch.where(rows_k < n, rows_k, INT32_PAD_KEY)   # still sorted
    ids = torch.arange(len(us), device=dev)
    out = {}
    for name, lay_x in (("all edges", lay), ("no edges", bare)):
        out[name] = device_ms(lambda: horner_push_rows(
            keys, vals, d, us, lay_x, tau, l_max=L), "horner_push_kernel", 50)
    out["level 0 only"] = device_ms(lambda: horner_push_rows(
        k0, rows_v, d, ids, lay, tau, l_max=L), "horner_push_kernel", 50)
    runs = max(int(level_runs_plain(rows_k, n, L)[1].max()), 1)
    per = {"bookkeeping, seeds and barrier":
           (out["no edges"] - out["level 0 only"]) / runs,
           "in-edges": (out["all edges"] - out["no edges"]) / runs}
    print(f"[kernel] horner_push n={g.n:,} B={len(us)} parts (device ms a "
          f"push): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + "; per level after the first: "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in per.items()))
    return {**out, **{f"per level: {k} (us)": v * 1e3
                      for k, v in per.items()}}


def horner_row(g, p, eng, nodes, launches: int, steps: int,
               scale, serve_row: dict) -> dict:
    """``horner_push`` at B = 8 (serving, the row) and B = 16 (the
    prior's batch, under ``b16``), each on a batch of the main path's
    nodes, and at B = 2 and 8 on phase 3e's 10^6-node engine (under
    ``n1e6``; ``scale`` is its (g, plan, engine)); see
    :func:`horner_push_case`. ``serve_row``, phase 3i's push at the
    sling-serve batch of 1,024 over 10^6 nodes, goes under ``b1024``."""
    import numpy as np

    from repro_torch.kernels.horner_push import persistent_grid
    cases = [horner_push_case(g, p, eng, nodes[512:512 + B])
             for B in (8, 16)]
    # at 10^6: the hub and the widest rows, whose seeds reach the
    # deepest levels (most rows hold level 0 alone at this eps)
    sg, sp, seng = scale
    wide = np.argsort(-seng.index.hp.counts.numpy(), kind="stable")
    big = [horner_push_case(sg, sp, seng, np.r_[np.argmax(sg.in_deg),
                                                wide[:B - 1]])
           for B in (2, 8)]
    for c, (gg, pp, ee) in [(c, (g, p, eng)) for c in cases] + \
            [(c, scale) for c in big]:
        print(f"[kernel] horner_push n={gg.n:,} B={c['B']}: "
              f"{c['levels_run']} of "
              f"{pp.l_max + 1} levels run in one launch (grid "
              f"{persistent_grid(ee._layout, c['B'])} blocks of 1,024); "
              f"whole push {c['push_ms']:.4f} ms (row ids on the card to "
              f"the (B, n) result, CUDA events); kernel {c['ms']:.4f} ms "
              f"(device time); before the launch only allocations, "
              f"{c['alloc_ms']:.4f} ms of host time; plain "
              f"{c['plain_ms']:.4f} ms; torch.sparse.mm x {pp.l_max + 1} "
              f"{c['library_ms']:.4f} ms; bound {c['bound_ms']:.5f} ms "
              f"({c['bound_by']}: inputs once, result once); streamed over "
              f"the levels run {c['streamed_bound_ms']:.5f} ms; max_abs_err "
              f"{c['max_abs_err']:.3g}; two pushes equal bits")
    row, b16 = cases
    return {"name": "horner_push", "route": "cuda",
            "source": "src/repro_torch/csrc/horner_push.cu",
            "replaces": "src/repro/kernels/horner_push/horner_push.py:69",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"]
                               for c in cases + big + [serve_row]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "steps": steps,
            "levels_run": row["levels_run"], "push_ms": row["push_ms"],
            "alloc_ms": row["alloc_ms"],
            "streamed_bound_ms": row["streamed_bound_ms"],
            "parts": row["parts"],
            "b16": {k: v for k, v in b16.items() if k not in ("B", "parts")},
            "n1e6": {f"B={c['B']}": {k: v for k, v in c.items()
                                     if k not in ("B", "parts")}
                     for c in big},
            "b1024": serve_row,
            "shape": f"B=8 W={eng._width_cap} n={g.n} m={g.m} "
                     f"levels={p.l_max + 1}"}


def profile_single_source(eng, q) -> None:
    """Where a warm single-source batch of 8 spends its time: the engine
    path's parts run alone on fresh nodes, each timed on the host clock
    and ending in a synchronize -- the ids to the card (``_ids``), the
    push, the (8, n) copy to the host, the per-row cache copies and the
    LRU inserts -- beside ``QueryEngine.single_source`` on fresh nodes;
    then a torch.profiler trace of one more batch."""
    import torch

    from repro_torch.core.single_source import batched_single_source
    from repro_torch.serve.engine import _LRU
    torch.cuda.synchronize()
    walls = []
    for lo in range(0, 32, 8):
        t0 = time.perf_counter()
        eng.single_source(q[lo:lo + 8])
        walls.append(time.perf_counter() - t0)
    parts = {k: [] for k in ("ids", "push", "copy_to_host", "row_copies",
                             "lru")}
    for lo in range(32, 48, 8):
        us = q[lo:lo + 8]
        t0 = time.perf_counter()
        ids = eng._ids(us).long()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = batched_single_source(eng._keys, eng._vals, eng._d,
                                    eng._layout, ids, eng._tau,
                                    n=eng.index.n,
                                    l_max=eng.index.plan.l_max,
                                    backend=eng._push_backend)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = out.cpu().numpy()
        t3 = time.perf_counter()
        rows = [host[j].copy() for j in range(len(us))]
        t4 = time.perf_counter()
        lru = _LRU(eng.cfg.cache_size)
        for u, r in zip(us, rows):
            lru.put(("src", int(u)), r)
        t5 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3),
                                     (t3, t4), (t4, t5))):
            parts[k].append((b - a) * 1e3)
    print("[profile] single_source: a warm batch of 8 through the engine "
          + " ".join(f"{w * 1e3:.3f}" for w in walls) + " ms; its parts "
          "alone (two batches): "
          + " ".join(f"{k}=" + "/".join(f"{v:.3f}" for v in vs) + "ms"
                     for k, vs in parts.items()))
    trace("one single_source batch of 8",
          lambda: eng.single_source(q[48:56]))


def profile_build(g, p, dev, blocks: int = 4) -> None:
    """Trace ``blocks`` blocks of the Enron build loop (Alg 2 with the
    masked ``spmm``, the prune, the extraction and the stop test)."""
    import numpy as np
    import torch

    from repro_torch.core import hp_index
    from repro_torch.kernels.spmv_ell import SpmmLayout
    lay = SpmmLayout.pull(g, p.sqrt_c, dev)
    theta = float(np.float32(p.theta))

    def run():
        for b0 in range(0, blocks * BLOCK, BLOCK):
            tid = torch.arange(b0, b0 + BLOCK, device=dev)
            h = torch.zeros((g.n, BLOCK), device=dev)
            h[tid, tid - b0] = 1.0
            hp_index._propagate_block_coo(h, lay, theta, p.l_max, tid)
    run()                                               # warm
    trace(f"{blocks} Enron build blocks of {BLOCK} targets", run)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="Enron",
                    help="Table-3 regime of generators.paper_scale")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path and in phases 3c and 3e, "
                         "trace a few more serve batches, four Enron "
                         "build blocks, one retrieval, eight batches of "
                         "the sparse scale build and an LM decode step at "
                         "decode_32k and long_500k with torch.profiler "
                         "and print the tables by device and by CPU time")
    ap.add_argument("--seed", type=int, default=0,
                    help="phase 3m's graph relabelling and gnn_batch data")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import build
    from repro_torch.graph import generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.horner_push import horner_push_rows
    from repro_torch.kernels.hp_join import hp_join
    from repro_torch.kernels.spmv_ell import spmm
    from repro_torch.serve import EngineConfig, QueryEngine

    # fp32 products stay fp32 (no TF32) everywhere in this script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build the kernels ------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f}s "
          + " ".join(f"{k}={v:.2f}s" for k, v in built.items()))
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. main path at real size --------------------------------------
    g = generators.paper_scale(args.graph, seed=0)
    print(f"[main] graph {args.graph}: n={g.n} m={g.m} "
          f"max in-degree={int(g.in_deg.max())}")
    hp_join.launches = horner_push_rows.launches = spmm.launches = 0
    horner_push_rows.steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = build.build_index(g, eps=EPS, c=0.6, seed=0, block=BLOCK,
                            device=dev, verbose=True)
    t_build = time.perf_counter() - t0
    p = idx.plan
    entries = int(idx.hp.counts.sum())
    print(f"[main] build_index eps={p.eps} c={p.c}: l_max={p.l_max} "
          f"theta={p.theta:.6g} n_r1={p.n_r1} d={idx.build_seconds['d']:.2f}s"
          f" hp={idx.build_seconds['hp']:.2f}s total={t_build:.2f}s "
          f"entries={entries} width={idx.hp.width} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    eng = QueryEngine(idx, g, EngineConfig(), device=dev)
    warm = eng.warmup()
    print("[main] warmup " + " ".join(f"{k}={v:.3f}s"
                                      for k, v in warm.items()))
    shapes = eng.stats()["unique_shapes"]
    rng = np.random.default_rng(0)
    nodes = rng.permutation(g.n)
    pair_u = nodes[:256].astype(np.int32)
    pair_v = nodes[256:512].astype(np.int32)
    src_q = nodes[512:576].astype(np.int32)
    top_q = nodes[576:640].astype(np.int32)
    queries = (pair_u, pair_v, src_q, top_q)
    answers, lat = serve_sample(eng, *queries)
    launches = {"hp_join": hp_join.launches,
                "horner_push": horner_push_rows.launches,
                "spmm": spmm.launches,
                "horner_push_steps": horner_push_rows.steps}
    st = eng.stats()
    for path, ls in lat.items():
        per = 64 if path == "pair" else 8
        print(f"[main] {path}: {len(ls)} batches of {per}: per batch "
              f"{pct(ls)}")
    print(f"[main] launches {launches}; backends pair={st['pair_backend']} "
          f"push={st['push_backend']}; batches={st['batches']} "
          f"pad_slots={st['pad_slots']} cache_hits={st['cache_hits']}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel did not launch on the main path: "
                           f"{launches}")
    if st["unique_shapes"] != shapes:
        raise RuntimeError("dispatch shape set grew after warmup")
    if st["pair_backend"] != "kernel" or st["push_backend"] != "kernel":
        raise RuntimeError(f"main path did not use the kernels: {st}")

    if args.profile:
        profile_serving(eng, nodes[640:704].astype(np.int32))
        profile_single_source(eng, nodes[704:760].astype(np.int32))
        profile_build(g, p, dev)

    plain = QueryEngine(idx, g, EngineConfig(pair_backend="join",
                                             push_backend="plain"),
                        device=dev)
    err = {
        "pair": float(np.abs(plain.pairs(pair_u, pair_v)
                             - np.concatenate(answers["pair"])).max()),
        "source": float(np.abs(plain.single_source(src_q[:16])
                               - np.concatenate(answers["source"][:2])
                               ).max()),
    }
    pv, pi = plain.topk(top_q[:16], 10)
    kv = np.concatenate([a[0] for a in answers["topk"][:2]])
    ki = np.concatenate([a[1] for a in answers["topk"][:2]])
    err["topk"] = float(np.abs(pv - kv).max())
    full = plain.single_source(top_q[:16])
    err["topk_ids"] = float(np.abs(full[np.arange(16)[:, None], ki]
                                   - pv).max())
    print(f"[main] kernels vs plain backends on the card: {err}")
    if max(err.values()) > TOL_KERNEL:
        raise RuntimeError(f"engine answers disagree with plain: {err}")
    del plain

    # ---- 3b. the dynamic-graph path at real size --------------------------
    upd = update_phase(g, dev)
    total = {k: launches[k] + upd[k] for k in launches}
    print(f"[update] launches {upd}; main path + update {total}")

    # ---- 3c. xDeepFM serving at full width, with the SLING prior -------
    model, serve_batch, rec = xdeepfm_phase(dev, profile=args.profile)
    for k in ("horner_push", "spmm", "horner_push_steps"):
        total[k] += rec[k]
    total["cin"] = rec["cin"]
    print(f"[xdeepfm] launches {rec}; all paths {total}")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # ---- 3d. the index artifact: save, load, mmap, quantize, §5 ----
        art = artifact_phase(g, idx, answers, queries, dev, tmp)
        for k in art:
            total[k] += art[k]
        print(f"[artifact] launches {art}; all paths {total}")

        # ---- 3e. the scale path at 10^6 nodes, then the build options --
        sc, scale = scale_phase(dev, tmp, profile=args.profile)
        opt = options_phase(g, idx, dev, tmp)
        for k in sc:
            total[k] += sc[k]
        total["spmm"] += opt["spmm"]
        print(f"[scale] launches {sc}; build options {opt}; all paths "
              f"{total}")

        # ---- 3f. the bulk join at Enron and at 10^6 ---------------------
        v3_path = str(Path(tmp) / "enron.sling")
        jn, enron_rows = join_phase(g, idx, eng, scale, dev, tmp, v3_path)
        for k in jn:
            total[k] += jn[k]
        print(f"[join] launches {jn}; all paths {total}")

        # ---- 3g. the serving frontend at Enron --------------------------
        fe = frontend_phase(g, v3_path, dev)
        for k in fe:
            total[k] += fe[k]
        print(f"[frontend] launches {fe}; all paths {total}")

        # ---- 3h. node-sharded build, serving, pod path, join, scale -----
        sh = sharded_phase(g, idx, eng, answers, queries, enron_rows, scale,
                           dev, v3_path)
        for k in sh:
            total[k] = total.get(k, 0) + sh[k]
        print(f"[sharded] launches {sh}; all paths {total}")

        # ---- 3i. baselines, oracles, entry points, sling-serve at size --
        base = baselines_phase(dev)
        serve, serve_row, sling_host = sling_serve_phase(dev, tmp)
        paper = {k: base[k] + serve[k] for k in base}
        for k in paper:
            total[k] += paper[k]
        print(f"[paper] launches {paper}; all paths {total}")
        if min(paper[k] for k in ("hp_join", "spmm", "horner_push")) <= 0:
            raise RuntimeError(f"a kernel did not launch in phase 3i: "
                               f"{paper}")

        # ---- 3j. xDeepFM training at full width ---------------------------
        tr = train_phase(dev, tmp)
        train_ms = tr.pop("train_kernel_ms")
        grad_errors = tr.pop("grad_errors")
        for k in tr:
            total[k] = total.get(k, 0) + tr[k]
        print(f"[train] launches {tr}; all paths {total}")

        # ---- 3k. the GNN stack: full_graph_sm, minibatch_lg, example ----
        gn = gnn_phase(g, dev, tmp)
        for k in gn:
            total[k] += gn[k]
        print(f"[gnn] launches {gn}; all paths {total}")

    # ---- 3l. the LM stack at the published widths -----------------------
    lm_phase(dev, profile=args.profile)

    # ---- 3m. the sharded models on meshes that repeat the card ----------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        sharded_models_phase(dev, tmp, args.seed)

    # ---- 3n. four cells on the card's (1, 1) mesh, predicted, measured --
    cells = cells_phase(dev, sling_host, args.seed)
    for k, v in cells.items():
        total[k] = total.get(k, 0) + v
    print(f"[cells] launches {cells}; all paths {total}")

    # ---- 3o. the static analyzer held against the card -------------------
    ana = analysis_phase(dev, sling_host)
    del sling_host
    for k, v in ana.items():
        total[k] = total.get(k, 0) + v
    print(f"[analysis] launches {ana}; all paths {total}")

    # ---- 4. each kernel vs its plain version at the main path's shapes --
    kernels = [hp_join_row(eng, idx, pair_u, pair_v, total["hp_join"]),
               horner_row(g, p, eng, nodes, total["horner_push"],
                          total["horner_push_steps"], scale, serve_row),
               slab_row(g, idx, eng, nodes,
                        total["horner_push_slabs"], dev)]
    del scale
    kernels.append(spmm_row(g, p, dev, nodes, total["spmm"]))
    kernels.append(cin_row(model, serve_batch, dev, total["cin"]))
    cin_stream_check(dev)
    kernels.extend(cin_grad_rows(model, serve_batch, dev, total, train_ms,
                                 grad_errors))
    del model
    for k in kernels:
        print(f"[kernel] {k['name']} {k['shape']}: max_abs_err="
              f"{k['max_abs_err']:.3g} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']}) library_ms={k['library_ms']}"
              + (f" fma_bound_ms={k['fma_bound_ms']:.5f}"
                 if "fma_bound_ms" in k else "")
              + "".join(f" {x}={k[x]}" for x in ROW_EXTRAS if x in k))
        # the cin rows are held relative to max |out| in their own checks
        if not k["name"].startswith("cin") and \
                not k["max_abs_err"] <= TOL_KERNEL:
            raise RuntimeError(f"{k['name']} disagrees with its plain "
                               f"version: {k['max_abs_err']}")
    del eng, idx

    # ---- 5. accuracy against exact SimRank -------------------------------
    accuracy_phase(dev)

    # ---- 6. output --------------------------------------------------------
    print(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                   if k not in ("shape", "fma_bound_ms",
                                                "parts", "b16", "n1e6",
                                                "b1024")}
                                  for kk in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
