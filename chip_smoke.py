"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:

1. card:    name and power limit (nvidia-smi); TF32 off.
2. build:   compile every CUDA kernel from csrc/, one nvcc per source,
            all started together.
3. model:   the synthetic model at full size, tables drawn on the card.
4. kernels: the lookup kernel against its plain PyTorch version on the
            ids and tables one forward passes it (captured from that
            forward), f32 and one bf16 table; kernel, plain and library
            device times (device_ms: CUDA events around calls queued
            ahead of the device) beside the device-memory bound.
5. forward: a few forwards at the global batch; every subgroup's lookup
            ran through the kernel; logits finite and equal to an
            independent plain reference on a slice of the batch; one
            more forward profiled (profile_once: its synced host wall
            and its device time on devprof's clock).
6. serving: a ServingEngine over the model's tables answers requests of
            1, 5, 64 and 4096 samples, each equal to the model's own
            lookup on the same ids.
7. train:   the model's tables, Adagrad accumulators and MLP in a
            training state (SparseAdagrad(0.01) and optax-style
            adagrad(0.01, 0.1, 1e-7), bce_with_logits: the JAX bench's
            configuration); one warm-up step, then 5 hybrid steps on
            distinct batches; every loss finite; every group's apply
            went through the segment-walk kernel and every lookup
            through the lookup kernel.
8. segwalk: the segment-walk kernel against its plain version on each
            group's update stream captured from one more real step, for
            sgd (bit-exact), adagrad_dedup and adagrad_sq (rtol = atol =
            1e-6), untouched rows unchanged, and one bf16 table; kernel
            device time over both passes (device_ms), plain time
            (CUDA events, one call), Tensor.index_add_ for sgd, the
            bound, the longest segment and the chunks of each stream;
            then each stream's three ops timed again in two orders (sgd
            first, and rotated), each order after one untimed warm-up
            apply.
9. profile: training steps profiled (profile_once: the least synced
            host wall of 3 steps after a warm-up, and the device time a
            step over 3 more steps queued while the device spins,
            devprof.device_clock_ms;
            the busy share is that over the wall when the steps were
            queued ahead, and a step that waits on the device inside is
            printed as CUDA events with the host's gaps, never as a busy
            share; torch.profiler is not used); one more step under
            torch's sync debug mode: its host syncs by source line.
9b. tiny-adam: on the same tables, lazy Adam (SparseAdam(0.001), the
            segment walk's 'adam' op; Adagrad on the MLP): one warm-up
            and 3 timed steps, every loss finite; a sample of 1 M rows
            a group that no step named keeps its weights bitwise and m =
            v = t = 0; one more step's streams, the kernel against its
            plain version on compact copies of the touched rows (t exact,
            m and v bit-exact, the table rtol = atol = 1e-6) and against
            what the step wrote (bit-exact); kernel and plain times, the
            bound (no library call computes lazy Adam).
9c. fit-tiny: on the same tables, drawn anew from the seed before each
            run, the resumable and self-healing training loop (grad.fit) with
            phase 7's optimizers (SparseAdagrad(0.01), Adagrad on the
            MLP): run A, 6 uninterrupted steps (each timed, synchronised;
            peak memory; the host syncs of one more step bare and inside
            fit); run B, the same 6 steps with
            CheckpointCallback(every=3, keep_last=1), one accumulator
            element made NaN after step 4, StateAuditor(every=1, full
            sweeps) finding it at step 4 and on_anomaly='rollback'
            restoring the step-3 file in place and replaying; run C, a
            fresh draw resumed from the step-3 file (fit(resume_from=dir))
            to step 6.  B and C equal A bit for bit (the audit digest of
            every table, accumulator, dense param and optimizer leaf, the
            count and the losses; the w16 table compared in full); every
            step launched the lookup (4) and the segment walk (2).  Save
            and restore seconds and GB/s (8.4 GB files), the audit's ms a
            call.
9d. ragged-tiny: on the same tables, drawn anew from the seed, the
            hotness-10 inputs as RaggedBatches on the card (rows of 1-10
            ids): one forward equal to the same ids in the dense layout
            bit for bit (densified at _ragged_cap: 16); a warm-up and 3
            hybrid steps (phase 7's optimizers) on the ragged inputs and
            the same on the dense layout from the same state, every loss
            finite, every lookup through the lookup kernel's dense arm
            and every apply through the segment walk; the tables of the
            two runs within rtol = atol = 1e-6 (bit-exact reported); the
            host syncs of one more step with and without hot_cap.
9e. hot-tiny: on the same tables, drawn anew from the seed, the hot-row
            cache: the JAX bench's hot sets (analytic_power_law_hot_sets,
            alpha 1.05: coverage 0.85 for training; 0.95 in 256 MiB with
            state_copies=0 for serving) and a second model with them,
            drawn from the same seed.  The cached forward against the
            uncached one at batch 65536 (bit-exact hotness 1, rtol = atol
            = 1e-6 hotness 10), every cold-row gather and hot partial on
            the lookup kernel (counted); the exchange counters
            (measure_exchange_counters) cache off and on; an engine with
            the serving hot sets answers requests of 1, 5, 64 and 4096
            samples equal to an engine without them; phase 7's optimizers,
            a warm-up and 5 timed steps each way from the same state
            (every loss finite, launches counted per step, peak memory),
            the canonical tables after them within rtol 2e-4 / atol 2e-6
            and the accumulators within 5e-3 / 5e-4 (the JAX hot-vs-off
            bounds), the host syncs of one step each way and one cached
            step profiled (profile_once); on one more captured cached step,
            each kernel against its plain version (the cold gathers and
            hot partials: lookup, exact at hotness 1, 1e-6 at 10; the hot
            and cold segment sums: 'add' into a zero-fill, bit-exact; the
            deduplicated cold applies:
            adagrad_dedup 1e-6 and against what the step wrote, sgd
            bit-exact) with device times beside the bound and the library
            call (embedding_bag, index_add_ into a zero-fill); then 2 lazy
            SparseAdam steps on the cached layer: losses finite, t > 0
            exactly at the hot rows the batches name, every other hot row
            keeps its weights bit for bit and m = v = t = 0; the last
            step's hot segment sums with their count column (width w + 1)
            against their plain version, timed.
9f. chunked-tiny: on the same tables, drawn anew from the seed, a
            second model with overlap_chunks=4 (bench.py's default; its
            subgroups of 31, 1, 24 and 2 slots take 4, 1, 4 and 2 chunk
            rounds: 11 lookup launches a forward against 4), drawn from
            the same seed (its tables checked equal).  Its forward, and
            one with fused_exchange=False, on the same tables equal the
            unchunked forward bit for bit at every hotness, launches
            counted; every launch of the chunked and of the unchunked
            forward against its plain version, timed beside its bound; a
            warm-up and 5 sparse steps (phase 7's optimizers) each way
            from the same state: tables, accumulators, MLP, dense
            optimizer state and every loss bit-equal, launches counted,
            step times, peaks and the host syncs of one step;
            measure_exchange_ms and a2a_overlap_stats of both arms (a
            world of one has no collective: the program times buffer
            plumbing only); the same with phase 9e's hot sets (forward and
            a warm-up and 5 steps bit-equal, hot buffers included; the
            hot apply in 4 row chunks); 2 dense make_train_step steps
            (phase 14's configuration) each way bit-equal, each arm's
            peak above its resident state.
9g. quant-tiny: the tiny model freed, the tiny model at full size in
            int8, then in fp8 (1.31 GiB of payloads and scales each,
            drawn and quantized on the card): the lookup kernel's
            dequantizing arm against its plain version on every lookup
            of a forward (bit-exact hotness 1, 1e-6 hotness 10), with
            kernel, plain and library (embedding_bag over the
            dequantized tables, the dequantization inside) device times
            beside the bound; a forward whose every lookup is on the
            dequantizing arm (counted), its first 512 samples equal to a
            plain gather of the dequantized tables; an engine serving
            the same values quantized answers requests of 1, 5, 64 and
            4096 samples equal to the model's lookup; phase 9e's hot
            sets over the same draw: the cached forward equal to the
            uncached one (bit-exact hotness 1) and a cached step;
            phase 7's optimizers, a warm-up and 3 steps (losses finite,
            every lookup on the dequantizing arm, every segment sum on
            the segment walk, counted), then one more step whose every
            requantization equals the numpy quantizer and whose rows
            named by no id keep their bits; in int8, one checkpoint
            (payload and scale pairs, accumulators, MLP) saved and
            restored in place, equal in every logical leaf, then
            exported into a serving bundle (int8 payload and f32 scale
            members, no optimizer member) and served by an engine built
            from the bundle alone (from_bundle, table_dtype 'auto':
            int8): requests of 1, 5, 64 and 4096 samples equal the
            model's lookup, every lookup on the dequantizing arm
            (counted).
9h. wire-ranks: the wire codec (wire_dtype) across ranks: two processes
            on the one card (both on cuda:0), joined over gloo, which
            stages CUDA tensors through host memory (NCCL cannot put two
            ranks on one card); they import nothing of JAX and load the
            kernels phase 2 built.  Each first checks that
            all_to_all_single, all_gather and all_reduce take CUDA
            tensors.  The tiny model at full size, global batch 65536
            (32768 a rank), each arm beside its wire_dtype=None twin
            drawn from the same seed (tables checked equal): 'table' on
            int8 tables (1.31 GiB) with phase 9e's hot sets and
            overlap_chunks=3; 'bfloat16' on the flat f32 layer (4.19
            GiB), one chunk.  Per arm 3 forwards, then a warm-up and 3
            hybrid steps (phase 7's optimizers) each way: forwards,
            tables, accumulators, MLP and its optimizer state bit-exact
            ('table') or within 2^-6 of each tensor's scale
            ('bfloat16'); every loss finite; every lookup and apply on
            the kernels, counted on each rank against the plan; each
            lookup launch of one wired forward (the dequantizing arm on
            the int8 arm's cold gathers and hot partials) and each
            segment-walk launch of one more wired step (sums bit-exact,
            applies on compact copies of their rows) captured on each
            rank and held against its plain version at these shapes;
            the wired plan's narrowed legs (uint8 for q8) with fewer bytes
            than their payload and the twin's collective count; the
            example's line (narrowed legs, wire against payload bytes)
            and the step wall times, which are gloo through the host.
            A rank that fails or outlasts its timeout fails the phase,
            its output printed.
9i. dcn-ranks: the two-axis mesh and the hierarchical exchange
            (dcn_sharding): four processes on the one card (all on
            cuda:0), a 2 x 2 (dcn, data) mesh over gloo; each checks
            all_to_all_single, all_gather and all_reduce on CUDA tensors
            over each of its three groups (data, dcn, product).  The
            tiny model at full size, global batch 65536 (16384 a rank),
            two arms, each a dcn_sharding=True model (tables over the
            axis product) beside its two-axis flat twin (tables over the
            data axis, replicated across slices) drawn from the same
            seed, the hierarchical draw checked equal to the twin's
            resharded (hierarchical_params): f32 uncached, one chunk;
            int8 with phase 9e's hot sets, overlap_chunks=3 and
            wire_dtype='table'.  Per arm 3 forwards, then a warm-up and
            3 hybrid steps (phase 7's optimizers) each way: forwards,
            losses, every real hierarchical row and accumulator against
            the trained-then-resharded flat ones, the MLP and its
            optimizer bit-exact; launches counted against the twin's
            (a gather and a combine a subgroup and chunk round where the
            twin has one lookup; the same segment walks); the DCN legs
            on the dcn axis (dcn/rows uint8 on the int8 arm);
            measure_exchange_counters on rank 0 (dcn_rows, dcn_rows_off,
            dcn_dedup_ratio above 1); each lookup of one hierarchical
            forward and each segment walk of one more step captured on
            each rank and held against its plain version (the library
            time of a dequantizing launch, here and in 9h: embedding_bag
            over a dequantized compact copy of the rows it reads).  Both
            9h and
            9i start their ranks through launch_ranks: a file
            rendezvous, each rank's output logged, a marker written
            after its work, os._exit(0); a rank that fails, leaves no
            marker or outlasts its timeout fails the phase.
9j. tier-tiny: the host-DRAM cold tier (cold_tier, parallel/coldtier.py)
            on the tiny model at full size with phase 9e's training hot
            sets, two arms (f32, then int8 tables), each a tiered model
            under a device_hbm_budget of half its resident twin's
            resident_table_bytes() beside that twin, both drawn from the
            same seed: the draw equal (each head against the twin's first
            rows, each host tail against the rest, bit for bit); the
            forward at batch 65536 equal bit for bit at every hotness,
            launches counted (one more lookup a tiered subgroup: the
            fetch buffers' gather); one batch's pre-pass, build_fetch
            (host gather + copy from pinned memory) and write_back timed,
            its fetched rows and bytes (fetch_stats); phase 7's
            optimizers, a warm-up and 3 timed steps each (launches
            counted, the f32 arm's applies on the segment walk's
            two-source arm), then tables, accumulators, hot buffers and
            their state over head and tail bit-exact against the twin;
            one more captured step: each gather of the fetch buffers
            (the dequantizing arm in int8) and each two-source apply
            against its plain version (compact copies of the touched head
            and tail rows; equal to what the step wrote), timed beside
            the bound; 5 steps through ColdFetchPipeline (its
            overlap_pct); peak device memory.
9k. obs-tiny: the observability layer (obs/) on the tiny model phase 9
            built (f32, dp_input, no cache, no tier), drawn anew from the
            seed before each run: 5 sparse steps through grad.fit
            (phase 7's optimizers) untraced, then the same traced
            (obs.enable(trace_path=)): the launches (4 lookups and 2
            applies a step) equal and the losses bit-equal; the trace
            through the port's trace_report --strict --require train/step,
            train/sync and the step's four phase spans (fwd/exchange,
            fwd/lookup_combine, bwd/exchange, apply/update), its report
            printed; devprof.profile_step on the forward's batch (the
            default SparseSGD on a private copy of the tables): every
            phase at least 0, its device lane through the report with
            every STEP_PHASES name required and device_ms above 0, each
            phase on the synced wall and on the device clock with each
            program's clock, the coverage, the embedding step beside
            phase 9's step and its host syncs; obs.measure_overhead at
            phase 9's median step.
10. dlrm:   the tiny models freed, the DLRM of examples/dlrm/main.py at
            the MLPerf Criteo-1TB table sizes (26 tables, 187,767,399
            rows x 128, bf16, about 44.8 GiB, no row cut), model-parallel
            input (dp_input=False), bf16 compute, drawn on the card;
            batches of the learnable power-law split (utils/data.py) in
            worker order.  3 forwards (one lookup launch each; the first
            512 samples equal a plain gather and the head on it); the
            lookup kernel against its plain version on the forward's ids
            (bit-exact), with embedding_bag as the library time.
11. dlrm-train: the example's trainer (SparseSGD(24) and SGD on the
            warm-up + poly-decay schedule): one warm-up step, 5 timed
            steps (one lookup and one segment-walk apply each), losses
            finite, peak memory below the card's.
12. dlrm-segwalk: one more step's sgd stream, the kernel against its
            plain version on a compact copy of the touched rows and
            against what the step wrote (bit-exact), a sample of 1 M
            untouched rows unchanged; kernel, plain and
            Tensor.index_add_ timed on the real table at lr 0 (which
            leaves it as it is, checked).
13. dlrm profile: one step profiled, one under sync debug mode, as in
            phase 9.
13b. dlrm-resume: the DLRM freed, examples/dlrm/main.py in process at
            the MLPerf widths, bf16, sparse trainer, dummy data; one cut:
            the vocabularies of gen_data.py's onechip preset (every
            vocabulary capped at 2,000,000 rows: 13,110,446 rows x 128,
            3.13 GiB on the card, 6.7 GB of f32 on disk).  A: 6 steps and
            --save_state; B: 3 steps and --save_state, then --load_state
            and 3 more and --save_state.  The two files' manifests list
            the same sha256 for every array; verify_checkpoint passes on
            the second (13h's export verifies the first) and rejects it
            with one byte flipped; --resume_dir
            with a truncated newest file falls back to the step-3 file,
            quarantines the bad one and ends equal to A.  Each run's steps
            launch one lookup and one apply each.  Save and restore
            seconds and GB/s; the free disk space first (too little
            fails the phase).
13h. dlrm-serve: run A's step-6 file of phase 13b (kept for this
            phase) served by examples/dlrm/serve.py in process: the
            bundle (26 tables at step 6, no optimizer member, each
            table's sha256 in its manifest the checkpoint's), an engine
            at batch 1024 on rungs 128, 256, 512 and 1024 with serving
            hot sets (coverage 0.98 in 512 MiB), 512 power-law requests
            of 1, 2, 4 and 8 samples through the three arms (each alone,
            the monolithic batcher, the ladder and pipeline batcher;
            concurrency 8, 2 ms) and the overload arm (one burst at a
            two-replica pool, deadline 50 ms, half low priority, replica
            0 quarantined half-way).  Every answer of the monolithic and
            the ladder arms equals lookup_padded on its request bit for
            bit; every lookup of those arms launched the lookup kernel
            as often as the plan says and the segment walk never
            (counted); every overload future resolved, served or shed,
            the retried and degraded answers equal to lookup_padded on
            the surviving replica; one batch at each rung, every launch
            of its lookup against its plain version (bit-exact) with
            kernel, plain, embedding_bag and bound; an engine from the
            bundle alone (from_bundle, no hot sets) answers 512 sampled
            samples equal to a plain gather of the bundle's arrays; the
            bundle with one byte flipped refuses to load; the three-arm
            and serve_over_* blocks printed with the card's name and
            power limit; the files deleted.  serve.py runs with --trace:
            the trace passes the port's trace_report --strict --require
            with the request path's spans (submit, enqueue, dispatch,
            lookup, execute, demux) and fwd/lookup_combine; from it, a
            lone request's split (the no-batching arm's serve/lookup and
            its forward's phase spans, a mean a request, beside the
            arm's p50) and, for the monolithic and the ladder+pipeline
            arms, the union of each stage's spans and its share of the
            arm's wall (serve/enqueue: queue residency).
            devprof.profile_serving of the bundle's engine and of
            serve.py's (hot sets): one dev/serve/execute event a rung
            (128, 256, 512, 1024), the trace through the report, no
            segment walk; rung 128's device time on devprof's clock.
            It deletes its bundle and keeps the step-6 file for 13i.
13i. dlrm-serve-ranks: the same step-6 file served by two rank
            processes on the one card (both cuda:0, joined over gloo
            through launch_ranks), each running examples/dlrm/serve.py's
            main with --dist_backend gloo: the leader exports the bundle
            and every rank loads it; 13h's arguments with 256 requests
            (one cut from 512); every rank's two engines (the overload
            arm's replicas) behind one serving.RankFrontEnd.  The leader
            runs the three arms and the overload arm (replica 0
            quarantined half-way); every answer of the monolithic and
            the ladder arms, and every served overload answer, equals a
            numpy gather of the bundle's rows bit for bit; every future
            resolved, served or shed.  On each rank every lookup launched
            the lookup kernel as often as the plan says and the segment
            walk never (counted); one batch at rungs 128 and 1024 (the
            warm-up's) has every launch held against its plain version
            (bit-exact) with kernel, plain, embedding_bag and bound ms
            (the ranks time in turn); the follower ran every batch the
            leader sent.  Both ranks exit 0 with their markers; the
            leader's block is printed with the card's name and power
            limit; the files deleted.  Its times are gloo through the
            host with two ranks sharing one card, not NCCL serving
            speeds.
13c. dlrm-hot: examples/dlrm/main.py --dp_input --hot_cache
            --param_dtype bfloat16 in process at phase 13b's onechip
            vocabularies (the same one cut), hot sets calibrated on the
            dummy data; 5 steps, the state audited after each (so every
            loss is checked finite), each step launching the lookup and
            the segment walk (counted against the plan); the calibration
            line printed; --save_state passes verify_checkpoint and
            restores into the same model without the cache with equal
            canonical tables.
13d. dlrm-chunked: the DLRM at the MLPerf sizes (bf16, 44.77 GiB, no
            cut) with dp_input=True, one layer with overlap_chunks=4 and
            one without over the same tables (two copies do not fit the
            card), group shapes equal; the 26 slots take rounds of 7, 7,
            6 and 6 (4 launches of [458752,1] / [393216,1] ids against
            one of [1703936,1]).  3 forwards each way, one forward's
            residuals and backward_to_mp's grads bit-equal, launches
            counted; each forward's launches against their plain
            versions, timed beside the bound; the example's trainer, a
            warm-up and 5 timed steps each way (the second from where the
            first left the tables: times and launches only); both arms'
            exchange programs.  Then examples/dlrm/main.py --dp_input
            --overlap_chunks 4 and --overlap_chunks 1 in process at phase
            13b's onechip vocabularies, 3 steps and --save_state each:
            the two files list the same sha256 for every array.
13e. dlrm-int8: examples/dlrm/main.py --table_dtype int8 --param_dtype
            float32's model and trainer at the MLPerf Criteo-1TB
            vocabularies, no cut (187,767,399 rows x 128: 22.38 GiB of
            int8 payload and 0.70 GiB of scales, drawn and quantized in
            blocks on the card), model-parallel input, f32 MLPs: one
            forward (one dequantizing lookup), its lookup against the
            plain version (bit-exact) timed beside the bound (no library
            call: it would need the 89.5 GiB f32 table); the example's
            sparse trainer (SparseSGD(24), SGD on the schedule), a
            warm-up and 4 timed steps (losses finite, one dequantizing
            lookup and one segment-walk 'add' each, counted), peak
            memory, the host syncs of one more step.
13f. dlrm-wire: a world of one: examples/dlrm/main.py --dp_input
            --wire_dtype bfloat16 and the same run without the flag in
            process at phase 13b's onechip vocabularies, 3 steps and
            --save_state each (one lookup and one apply a step, counted):
            the files list the same sha256 for every array (a world of
            one ships nothing); --wire_dtype table --table_dtype int8
            --param_dtype float32 is accepted and prints that no leg was
            narrowed.  Then the codec at the DLRM's 1,703,936 rows x 128
            (torch ops, not a kernel): for int8 and fp8 grid rows the
            card's encode equals the numpy encoder's bytes on the host
            copy and decode(encode) is the identity; the bf16 cast equals
            the CPU's; encode, decode and cast timed (device_ms) beside
            their bound (each byte read and written once).
13g. dlrm-tier: host memory read from /proc/meminfo (MemTotal,
            MemAvailable); gen_data.py's writer puts 16 batches of 65536
            samples of the learnable power-law split (and one test
            batch) at the MLPerf Criteo-1TB vocabularies into a directory
            under build/ (deleted after), the largest vocabularies capped
            only if MemAvailable cannot hold the host tail plus 16 GiB
            (the cut printed as reduced); the Python reader timed over
            it; then examples/dlrm/main.py --dataset_path --dp_input
            --hot_cache --cold_tier_budget_mb 61440 --param_dtype float32
            --max_steps 12 --loader_bench in process (the example sizes
            the fetch capacity on a batch held out of the hot-set
            calibration): the f32 tables (96.1 GB) larger than the card,
            60 GiB of heads on it and the tails in host memory, hot sets
            calibrated on the dataset, the native reader required (its
            samples/s from --loader_bench).  Every loss finite; step 1
            (the first with a non-zero learning rate) is captured: each
            gather of its fetch buffers and its two-source apply against
            the plain version at the step's shapes (the apply on compact
            copies of the touched head and tail rows, bit-exact for sgd,
            and equal to what the step wrote), timed beside the bound;
            around it every tail row the step fetched changed and every
            other tail row kept its bytes (sha1 of every block of the
            tails before and after, the fetched rows put back); after
            the last step 512 samples' forward equal bit for bit a
            plain gather of their rows from the hot buffers, the heads
            and the host tails, and the head's logits on it (the checks'
            own launches not counted); each build_fetch and write_back
            timed, each batch's pre-pass on the pipeline's worker and the
            step's wait for it, the pipeline's overlap over the steps
            from 5 on (the queue filled during step 1's checks), the step
            times and the peak device memory; every kernel and the
            two-source arm launched on the run (counted).
14. dense-tiny: the DLRM freed, the tiny model at full size again,
            trained by the dense autodiff step (grad.make_train_step:
            autograd through the lookup kernel, whose backward is the
            segment walk's 'add', then optax-style Adagrad(0.01, 0.1,
            1e-7) on every param, tables included): one warm-up step, 5
            timed steps (every loss finite, 4 lookups and 2 backward
            applies a step, peak memory below the card's); one more
            step's table gradient of every group from the kernel against
            the plain version on the same stream (bit-exact, untouched
            rows exactly zero), with the device times of the kernel's
            function (zero-fill + 'add'), its parts, the plain version
            and Tensor.index_add_ into a zero-fill, beside the bound of
            the function and that of the 'add' alone.
15. dense-dlrm: the tiny model freed, examples/dlrm/main.py --trainer
            dense's model and trainer (bf16, dp_input=False, the MLPerf
            widths, every vocabulary capped at 10 M rows: 54,063,992
            rows, 12.89 GiB) with the checks of phase 14 (1 lookup and 1
            backward apply a step), and the lookup kernel against its
            plain version on this table.
16. dense profile: right after each of phases 14 and 15, one dense step
            profiled and one under sync debug mode, as in
            phase 9.
17. small:  the dense models freed, synthetic Small V3 at full size
            (107 tables, 220,630,300 rows at widths 16 and 32, hotness 1
            and 30, 13.15 GiB of bf16 tables, no cut), bf16 compute,
            dp_input=True, drawn on the card: the lookup kernel against
            its plain version on the ids of a forward (phase 4's checks),
            then 3 forwards (4 lookups each) checked as in phase 5 (bf16:
            hotness 30 within one bf16 ulp, logits within 2e-2).
18. small-train: the JAX bench's jumbo-scale optimizer configuration,
            SparseAdagrad(0.01, stream_dtype='bfloat16', accum_dtype=
            'bfloat16', use_segwalk_apply=True) and adagrad(0.01, 0.1,
            1e-7) on the bf16 MLP (26.29 GiB of tables and bf16
            accumulators): one warm-up step, 5 timed steps, every loss
            finite, every apply through both bf16 arms (counted per arm),
            peak memory below the card's; then a profiled step and one
            under sync debug mode, as in phase 9.
19. small-segwalk: one more step's two streams: adagrad_dedup on both
            bf16 arms against the plain version on compact copies of the
            touched rows (rtol = atol = 1e-6) and against what the step
            wrote (bit-exact), sgd on the bf16 stream (bit-exact), a
            sample of untouched rows unchanged; kernel, plain, bound, the
            same stream on the f32 arms (an f32 stream and accumulator)
            and Tensor.index_add_ of the bf16 rows (the sgd library
            time), timed on the real tables at lr 0.
20. ragged-lookup: Small V3 freed, the lookup microbenchmark's entry
            point (examples/benchmarks/lookup_benchmark.py) at its full
            size: one 1 M x 128 f32 table, 65536 ragged rows of 1-61 ids
            (about 2.03 M), the ragged and padded forwards, the gradient,
            the sparse and dense SGD timed (CUDA events); every ragged
            forward (the gradient's too) on the lookup kernel's CSR arm,
            every backward and sparse SGD on the segment walk (counted).
            Then the CSR arm against its plain version on those ids (sum
            and mean, f32 and a bf16 copy; rtol = atol = 1e-6, bit-exact
            where every row has one id), the backward's 'add' and the
            sparse SGD against theirs (bit-exact, untouched rows
            unchanged); kernel, plain and embedding_bag (offsets) device
            times beside the bound (each distinct row read once, as phase
            4 counts; every gathered row once beside it).

Launches are counted per path: the forward's, the serving requests'
(counted from 0 after the engine's warm-up) and the training steps'
(counted from 0 after the warm-up step); the DLRM's forwards and
training steps likewise, the dense steps of each model, the lazy-Adam
steps and Small V3's forwards and steps, and for the last two each arm
of the segment walk they ran (``segwalk.ARM_LAUNCHES``); each run of
phases 9c and 13b, phase 9d's steps, phase 9e's forward, requests,
steps and lazy-Adam steps, phase 13c's run, each arm of phases 9f
and 13d (forwards, sparse, cached and dense steps, the example runs)
phase 9g's forward, requests and steps of each dtype and its bundle
engine's requests, phase 13h's arms (the engine's warm-up and the
no-batching arm, the monolithic arm, the ladder arm, the overload arm),
phase 13e's
forward and steps (with the dequantizing arm's launches), phase 9h's
and 9i's forwards and steps on each rank, phase 13f's example runs and phase 20's
benchmark (with the CSR arm's launches, ``lookup.ARM_LAUNCHES``).
The line before last is the kernels' JSON summary (the lookup, the
segment walk, its two bf16 arms, its adam op, the lookup's CSR arm and
its dequantizing arm: launches from phase 13e's steps, times at its
shape, the tiny models' shapes beside them; the segment walk's
two-source arm: launches from phase 13g's steps, times at phase 9j's
shapes, and the lookup's tier gathers under ``tier_tiny``; the lookup's
serving launches under ``dlrm_serve``, one batch a rung of phase 13h,
and each rank's of phase 13i under ``dlrm_serve_ranks``);
each row
and summary with a kernel time says by which ``clock``:
``queued`` (CUDA events around back-to-back calls queued ahead of the
device, so no launch gap counts) or ``events: <keys>`` (the times of
calls that wait on the device, their gaps counted).
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 1 and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import gc
import io
import itertools
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch import obs, optim, serving
from distributed_embeddings_tpu_torch.analysis import commsan, graphlint
from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.examples.benchmarks import (
    lookup_benchmark)
from distributed_embeddings_tpu_torch.examples.dlrm import gen_data
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.examples.dlrm import serve as dlrm_serve
from distributed_embeddings_tpu_torch.models import dlrm
from distributed_embeddings_tpu_torch.models.synthetic import (
    SYNTHETIC_MODELS, InputGenerator, SyntheticModel, expand_tables)
from distributed_embeddings_tpu_torch.obs import devprof
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.ops import lookup, segwalk
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
from distributed_embeddings_tpu_torch.parallel import (audit, callbacks,
                                                       checkpoint, coldtier,
                                                       grad, hotcache,
                                                       overlap, quantization,
                                                       routing, sparse)
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.serving import batcher as serve_batcher
from distributed_embeddings_tpu_torch.serving import bench as serve_bench
from distributed_embeddings_tpu_torch.serving import pool as serve_pool
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
from distributed_embeddings_tpu_torch.tools import graphlint as graphlint_cli
from distributed_embeddings_tpu_torch.tools import trace_report
from distributed_embeddings_tpu_torch.tools import verify_checkpoint
from distributed_embeddings_tpu_torch.utils import (data, fastloader,
                                                    nativebuild)

# H100 SXM data-sheet peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNELS = [{
    'name': 'lookup_combine',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/lookup_combine.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_lookup.py:131',
}, {
    'name': 'segwalk_apply',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_segwalk.py:119',
}]
# the segment walk's arms and its adam op: template instances of the same
# source (built with it)
ARMS = [{
    'name': 'segwalk_apply:bf16_stream',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_segwalk.py:233',
}, {
    'name': 'segwalk_apply:bf16_accumulator',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_segwalk.py:326',
}, {
    # lazy Adam: an XLA apply in the JAX package, an op of the segment walk
    # here
    'name': 'segwalk_apply:adam',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/parallel/sparse.py:563',
}]
# the lookup's row-offsets (CSR) arm: an arm of the same source, built
# with it; it stands in for the JAX package's XLA _ragged_combine
CSR_ARM = {
    'name': 'lookup_combine:csr',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/lookup_combine.cu',
    'replaces': 'distributed_embeddings_tpu/ops/embedding_lookup.py:114',
}
# the lookup's dequantizing arm (quantized tables): an arm of the same
# source, built with it; it stands in for the JAX package's XLA
# _fused_lookup scale branch (the Pallas kernel had no such arm)
DEQUANT_ARM = {
    'name': 'lookup_combine:dequant',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/lookup_combine.cu',
    'replaces': 'distributed_embeddings_tpu/parallel/dist_embedding.py:2984',
}
# the segment walk's two-source arm (the cold tier's apply): an arm of the
# same source, built with it; it stands in for the JAX package's tiered
# apply, which concatenates the head and the fetched tail
TWO_SOURCE_ARM = {
    'name': 'segwalk_apply:two_source',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/parallel/sparse.py:1332',
}
MODEL = 'tiny'
BATCH = 65536  # global batch of the forward and of training
REQUEST_SIZES = (1, 5, 64, 4096)
SERVE_BATCH = 4096
TRAIN_STEPS = 5
ADAM_STEPS = 3
LR = 0.01  # the JAX bench's Keras Adagrad defaults
DLRM_ALPHA = 3.0  # examples/dlrm/gen_data.py's default skew
# the ops of the hybrid step's apply that phase 8 holds to the plain version
HYBRID_OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq')
# the dense DLRM's one cut: every MLPerf vocabulary capped at 10 M rows
# (54,063,992 rows, 12.89 GiB of bf16 tables).  The dense step's peak is
# about three table-sized tensors (the tables, their table-shaped bf16
# gradient and the update ``g * -lr``); the full 44.77 GiB would need
# about 134 GiB.  Whether a larger cap fits is open (PERF.md section 7).
DENSE_DLRM_MAX_ROWS = 10_000_000
FIT_STEPS = 6  # phase 9c's runs; the checkpoint at step 3
RAGGED_STEPS = 3  # phase 9d's hybrid steps after its warm-up
# phase 9e's hot sets: the JAX bench's defaults (bench.py --alpha,
# --hot_coverage, --serve_hot_coverage, --serve_hot_budget_mb)
HOT_ALPHA = 1.05
HOT_COVERAGE = 0.85
SERVE_HOT_COVERAGE = 0.95
SERVE_HOT_BUDGET = 256 << 20
HOT_ADAM_STEPS = 2  # phase 9e's lazy-Adam steps on the cached layer
DLRM_HOT_STEPS = 5  # phase 13c's steps
CHUNKS = 4  # phases 9f and 13d: bench.py's default overlap_chunks
CHUNKED_DENSE_STEPS = 2  # phase 9f's dense steps each way
CHUNKED_EXAMPLE_STEPS = 3  # phase 13d's example runs
QUANT_DTYPES = ('int8', 'float8_e4m3')  # phase 9g's two tiny models
QUANT_STEPS = 3  # phase 9g's steps after the warm-up, each dtype
DLRM_INT8_STEPS = 4  # phase 13e's steps after the warm-up
# phase 9h: two ranks on the one card over gloo, each arm beside its
# wire_dtype=None twin; 'table' on phase 9e's hot sets (True stands for
# them) with int8 tables in 3 chunk rounds, 'bfloat16' on the flat f32
# layer
WIRE_WORLD = 2
WIRE_ARMS = (('table', {'table_dtype': 'int8', 'hot_cache': True,
                        'overlap_chunks': 3}),
             ('bfloat16', {}))
WIRE_FORWARDS = 3
WIRE_STEPS = 3  # after a warm-up, each arm and twin
WIRE_TIMEOUT_S = 600  # both ranks, start to end
COMMSAN_TIMEOUT_S = 120.0  # phase 9h: a barrier's wait for the peer's digest
BF16_WIRE_BOUND = 2.0**-6  # the JAX package's bound for the bf16 wire
WIRE_EXAMPLE_STEPS = 3  # phase 13f's example runs
# phase 9i: a 2 x 2 (dcn, data) mesh of four ranks on the one card; each
# arm a dcn_sharding=True model beside its two-axis flat twin
DCN_SHAPE = (2, 2)
DCN_ARMS = (('f32', {}),
            ('int8', {'table_dtype': 'int8', 'hot_cache': True,
                      'overlap_chunks': 3, 'wire_dtype': 'table'}))
DCN_FORWARDS = 3
DCN_STEPS = 3  # after a warm-up, each arm and twin
DCN_TIMEOUT_S = 600  # all four ranks, start to end
DLRM_WIRE_ROWS = 1_703_936  # the DLRM's looked-up rows a step (65536 x 26)
# phase 13b's one cut: examples/dlrm/gen_data.py --preset onechip
ONECHIP_MAX_ROWS = 2_000_000
TIER_DTYPES = (None, 'int8')  # phase 9j's arms: f32 and int8 tables
TIER_STEPS = 3  # phase 9j's steps after the warm-up, tier and twin
TIER_PIPE_STEPS = 5  # phase 9j's pipelined steps
TIER_BUDGET_MB = 61440  # phase 13g: 60 GiB of tables on the card
TIER_HOST_HEADROOM = 16 << 30  # host memory phase 13g keeps beside the tail
TIER_DLRM_BATCHES = 16  # phase 13g's written train batches
TIER_DLRM_STEPS = 12
TIER_CHECK_STEP = 1  # the first step with a non-zero learning rate
TIER_STEADY_FROM = 5  # phase 13g's steps past the queue step 1's checks fill
# the checkpoint files of phases 9c and 13b, inside the checkout (build/
# is not committed)
CKPT_DIR = pathlib.Path(__file__).resolve().parent / 'build' / 'chip_smoke_ckpt'
SERVE_DIR = CKPT_DIR / 'serve'  # phase 13h: 13b's step-6 file, the bundle
# phase 13h: examples/dlrm/serve.py's arguments beside --checkpoint
SERVE_ARGV = ['--batch', '1024', '--serve_buckets', '128,256,512,1024',
              '--requests', '512', '--request_sizes', '1,2,4,8',
              '--concurrency', '8', '--max_delay_ms', '2', '--alpha', '1.05',
              '--hot_coverage', '0.98', '--hot_budget_mb', '512',
              '--overload_qps', '0', '--replicas', '2', '--deadline_ms',
              '50', '--priority_mix', '0.5']
SERVE_CHECK_SAMPLES = 512  # phase 13h: from_bundle answers held
# phase 13i: two ranks on the one card serve 13h's arguments with 256
# requests (a cut from 512)
SERVE_RANKS_WORLD = 2
SERVE_RANKS_ARGV = ['256' if i and SERVE_ARGV[i - 1] == '--requests' else a
                    for i, a in enumerate(SERVE_ARGV)]
SERVE_RANKS_CHECK_RUNGS = (128, 1024)
SERVE_RANKS_TIMEOUT_S = 600  # both ranks, start to end
PROFILE_REPS = 3  # profile_once's and devprof's calls on the device clock
OBS_DIR = pathlib.Path(__file__).resolve().parent / 'build' / 'chip_smoke_obs'
OBS_STEPS = 5  # phase 9k's fit steps, untraced and traced
LINT_CALLS = 3  # phase 9l: a train program's warm-up and monitored calls
LINT_BUDGET = 0.5  # phase 9l's cold-fetch budget: this of the resident bytes
OBS_REQUIRE = ('train/step,train/sync,fwd/exchange,fwd/lookup_combine,'
               'bwd/exchange,apply/update')
SERVE_REQUIRE = ('serve/submit,serve/enqueue,serve/dispatch,serve/lookup,'
                 'serve/execute,serve/demux,fwd/lookup_combine')


T_START = time.perf_counter()  # main() sets it when the run starts


def log(*args):
  print(*args, flush=True)


def elapsed(phase):
  """One line: the seconds since the run started, after ``phase``."""
  log(f'[elapsed] {time.perf_counter() - T_START:.1f} s after {phase}')


def event_ms(fn, iters: int, warmup: int = 2) -> float:
  """Mean time per call of ``fn`` between two CUDA events around
  ``iters`` back-to-back calls: device time plus any gap the host leaves
  between launches."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


class EventMs(float):
  """A time from CUDA events around calls the host could not queue ahead
  of the device (a call that waits on the device): it counts the gaps
  the host leaves between launches.  A sum with it keeps the mark, and
  ``clocked`` names it in the ``clock`` of every row holding one."""

  def __add__(self, other):
    return EventMs(float(self) + other)

  __radd__ = __add__


QUEUE_TRIES = 3  # device spins, each 4x longer, before the gaps are kept
SLEEP_MS = 20.0  # the first spin: enough to queue 20 calls of any kernel
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep spins clock cycles;
                                 # an H100 runs at most 1.98 GHz


def mean_ms(times) -> float:
  """The mean of ``times``, an ``EventMs`` if any of them is one."""
  m = statistics.mean(times)
  return EventMs(m) if any(isinstance(t, EventMs) for t in times) else m


def clocked(obj):
  """``obj`` (rows and summaries of timings) with each dict that holds a
  kernel time (``ms`` or ``kernel_ms``) marked ``clock``: ``'queued'``
  where every ``device_ms`` time in it came from calls queued ahead of
  the device, else ``'events: <keys>'`` naming its ``EventMs`` times.  A
  plain version timed over one call (``plain_ms_of``) is a CUDA-event
  time with its gaps in either case."""
  if isinstance(obj, list):
    return [clocked(v) for v in obj]
  if not isinstance(obj, dict):
    return obj
  out = {k: clocked(v) for k, v in obj.items()}
  if 'ms' in obj or 'kernel_ms' in obj:
    gaps = [k for k, v in obj.items() if isinstance(v, EventMs)]
    out['clock'] = 'events: ' + ', '.join(gaps) if gaps else 'queued'
  return out


def device_ms(fn, iters: int, warmup: int = 2, floor_ms: float = 0.0
              ) -> float:
  """Mean device time per call of ``fn`` over ``iters`` back-to-back
  calls, between two CUDA events.  The device first spins
  (``torch.cuda._sleep``) while the host queues every call, so no gap of
  the host's launches lands between the events: a short kernel launched
  from Python spends longer in the launch than on the device.  The calls
  were queued ahead when the device has not reached the first event by
  the time the host has queued the last; if it has, the spin is made 4x
  longer, up to ``QUEUE_TRIES`` spins, and then the time, gaps and all,
  is an ``EventMs`` (a call that waits on the device).  torch.profiler
  is not the clock: on the card it lost some or all of its records from
  some point in a run on.  A time below ``floor_ms`` (the least time the
  card could take for the work) fails the phase: the bound or the clock
  is wrong."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  sleep_ms = SLEEP_MS
  for _ in range(QUEUE_TRIES):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    ahead = not start.query()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    if ahead:
      break
    sleep_ms *= 4
  else:
    ms = EventMs(ms)
    log(f'[timing] the calls could not be queued ahead of the device '
        f'(they wait on it); CUDA events with the host\'s gaps: {ms:.4f} '
        'ms a call (an EventMs)')
  if ms < floor_ms:
    raise AssertionError(f'{ms:.4f} ms a call, below the bound '
                         f'{floor_ms:.4f} ms: the bound or the clock is '
                         'wrong')
  return ms


def phase_card():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  # bf16 GEMMs (the DLRM phase) reduce in f32 throughout
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  log(card)
  log(f'[card] torch {torch.__version__} cuda {torch.version.cuda}; '
      'tf32 off for matmul and cudnn (allow_tf32 = False); bf16 GEMMs '
      'without reduced-precision reductions')
  return card


def phase_build():
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as pool:
    host = pool.submit(nativebuild.build_host, 'fastloader')
    built = list(pool.map(nativebuild.build, [k['name'] for k in KERNELS]))
    built.append(host.result())
  for b in built:
    log(f'[build] {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}')
    for line in b.log.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'[build]   {line.strip()}')
  log(f'[build] all kernels and the host reader in '
      f'{time.perf_counter() - t0:.2f} s (one compiler per source, in '
      'parallel)')


def pad_multi_hot(cats, hotness, rng):
  """Variable-length multi-hot rows: each hotness > 1 row keeps a random
  prefix of 1..h ids and pads the rest with -1 (the serving layout)."""
  out = []
  for c, h in zip(cats, hotness):
    c = np.array(c, dtype=np.int32)
    if h > 1:
      keep = rng.integers(1, h + 1, size=(c.shape[0], 1))
      c[np.arange(h)[None, :] >= keep] = -1
    else:
      c = c.reshape(-1)
    out.append(c)
  return out


def captured_lookups(model, numerical, cats):
  """The (table, routed ids, combiner) of every subgroup's lookup in one
  forward (``fused_group_lookup`` calls), taken from the forward itself;
  its launches are not counted towards any path."""
  calls = []
  kernel = lookup.fused_group_lookup

  def record(table, routed, combiners, compute_dtype, scale=None):
    calls.extend((table, r, c) if scale is None else (table, r, c, scale)
                 for r, c in zip(routed, combiners))
    return kernel(table, routed, combiners, compute_dtype, scale)

  lookup.fused_group_lookup = record
  try:
    with torch.no_grad():
      model(numerical, cats)
  finally:
    lookup.fused_group_lookup = kernel
  return calls


def check_kernel_shape(table, ids, label):
  """One kernel-vs-plain comparison and its timings at one shape."""
  m, h = ids.shape
  w = table.shape[1]
  got = lookup.dense_lookup(table, ids, 'sum', out_dtype=torch.float32)
  want = lookup.dense_lookup_reference(table, ids, 'sum', torch.float32)
  torch.cuda.synchronize()
  err = float((got - want).abs().max()) if m else 0.0
  if h == 1:
    ok = torch.equal(got, want)
    tol = 'bit-exact'
  else:
    ok = torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    tol = 'rtol=atol=1e-6 (sum order)'
  if not ok:
    raise AssertionError(f'{label}: kernel disagrees with plain version, '
                         f'max abs err {err} (tolerance {tol})')
  mask = (ids >= 0) & (ids < table.shape[0])
  safe = torch.where(mask, ids, 0).long()
  weights = mask.to(table.dtype)
  kernel = lambda: lookup.dense_lookup(table, ids, 'sum', torch.float32)
  plain = lambda: lookup.dense_lookup_reference(table, ids, 'sum',
                                                torch.float32)
  library = lambda: torch.nn.functional.embedding_bag(
      safe, table, mode='sum', per_sample_weights=weights)
  # the least bytes: each id read once, each DISTINCT row read once,
  # each output written once (a row gathered again may hit L2)
  valid = int(mask.sum())
  distinct = int(torch.unique(ids[mask]).numel())
  row_bytes = w * table.element_size()
  nbytes = m * h * 4 + distinct * row_bytes + m * w * 4
  gathered_bytes = m * h * 4 + valid * row_bytes + m * w * 4
  flops = valid * w
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / F32_FLOP_PER_S * 1e3
  floor = max(bytes_ms, ops_ms)
  kernel_ms = device_ms(kernel, 20, floor_ms=floor)
  plain_ms = device_ms(plain, 5, floor_ms=floor)
  library_ms = device_ms(library, 20, floor_ms=floor)
  kernel_event_ms = event_ms(kernel, 20)
  row = {
      'shape': label, 'M': m, 'h': h, 'w': w,
      'dtype': str(table.dtype).replace('torch.', ''),
      'valid_ids': valid, 'distinct_rows': distinct, 'bytes': nbytes,
      'gathered_bytes': gathered_bytes,
      'gathered_bound_ms': gathered_bytes / HBM_BYTES_PER_S * 1e3,
      'max_abs_err': err,
      'tolerance': tol, 'kernel_ms': kernel_ms, 'plain_ms': plain_ms,
      'library_ms': library_ms, 'kernel_event_ms': kernel_event_ms,
      'bound_ms': max(bytes_ms, ops_ms),
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
  }
  log('[kernels] ' + json.dumps(clocked(row)))
  return row


def phase_kernels(model, numerical, cats, bf16_copy=True):
  calls = captured_lookups(model, numerical, cats)
  if any(c != 'sum' for _, _, c in calls):
    raise AssertionError('the synthetic models combine with sum only')
  label = lambda t, r: f'w{t.shape[1]}_h{r.shape[-1]}_ncap{r.shape[0]}'
  rows = [check_kernel_shape(t, r.reshape(-1, r.shape[-1]), label(t, r))
          for t, r, _ in calls]
  if not bf16_copy:
    return rows, None
  # one bf16 table: the widest multi-hot lookup, cast
  t, r, _ = max(calls, key=lambda c: (c[1].shape[-1], c[0].shape[1]))
  bf16_row = check_kernel_shape(t.to(torch.bfloat16),
                                r.reshape(-1, r.shape[-1]),
                                label(t, r) + '_bf16')
  return rows, bf16_row


def plain_embedding_outputs(weights, input_table_map, cats, n):
  """Independent reference of the embedding outputs for the first ``n``
  samples: gather the global tables and sum the valid rows, in f32."""
  outs = []
  for tid, c in zip(input_table_map, cats):
    t = weights[tid]
    ids = torch.as_tensor(np.asarray(c)[:n]).to(t.device).reshape(n, -1)
    mask = (ids >= 0)
    rows = t[torch.clamp(ids, 0, t.shape[0] - 1).long()].float()
    acc = torch.zeros((n, t.shape[1]), dtype=torch.float32, device=t.device)
    for j in range(ids.shape[1]):
      acc = acc + torch.where(mask[:, j, None], rows[:, j], 0.0)
    outs.append(acc)
  return outs


def phase_forward(model, numerical, cats, n_forwards=3, n_check=512,
                  tag='forward'):
  """A few forwards at the global batch, every subgroup's lookup through
  the kernel; the logits finite and the first ``n_check`` samples equal
  an independent plain reference: bit-exact at hotness 1 (in the
  model's compute dtype), within rtol = atol = 1e-6 above (sum order;
  one bf16 ulp, 2**-8 relative, in bf16), logits within 1e-5 (f32) or
  2e-2 (bf16 GEMMs at another shape than the slice's)."""
  dist = model.dist_embedding
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times = []
  with torch.no_grad():
    for _ in range(n_forwards):
      t0 = time.perf_counter()
      logits = model(numerical, cats)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if launches != {'lookup_combine': n_forwards * n_subs,
                  'segwalk_apply': 0}:
    raise AssertionError(f'{tag}: launched {launches}, expected '
                         f'{n_forwards} x {n_subs} subgroups lookups')
  batch = np.asarray(cats[0]).shape[0]
  if tuple(logits.shape) != (batch, 1) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f'{tag}: logits {tuple(logits.shape)} not finite '
                         f'or not [{batch}, 1]')
  f32 = model.compute_dtype == torch.float32
  # independent reference on the first n_check samples
  weights = checkpoint.get_weights(dist, model.embedding_params)
  with torch.no_grad():
    outs = dist.apply(model.embedding_params, [c[:n_check] for c in cats])
    ref = plain_embedding_outputs(weights, model.input_table_map, cats,
                                  n_check)
    for i, (o, r, h) in enumerate(zip(outs, ref, model.hotness)):
      o, r = o.float(), r.to(o.dtype).float()
      if h == 1 and not torch.equal(o, r):
        raise AssertionError(f'{tag} input {i}: forward != plain reference')
      if h > 1 and not torch.allclose(o, r, rtol=1e-6 if f32 else 2**-8,
                                      atol=1e-6):
        raise AssertionError(f'{tag} input {i}: forward != plain reference '
                             f'(max err {float((o - r).abs().max())})')
    ref_logits = model.head(np.asarray(numerical)[:n_check], ref)
    tol = 1e-5 if f32 else 2e-2
    if not torch.allclose(logits[:n_check], ref_logits, rtol=tol, atol=tol):
      err = float((logits[:n_check] - ref_logits).abs().max())
      raise AssertionError(f'{tag}: logits disagree with the plain reference '
                           f'(max err {err}, tolerance {tol})')
  log(f'[{tag}] batch {batch}: {n_forwards} forwards, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised); '
      f'kernel launches {json.dumps(launches)}: {n_forwards} x {n_subs} '
      'subgroups')
  log(f'[{tag}] tables {model.total_table_gib():.3f} GiB; peak device '
      f'memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; '
      f'logits finite, first {n_check} equal the plain reference')
  return weights, launches


def profile_once(fn, tag, what, reps=PROFILE_REPS):
  """Where a call of ``fn`` spends its time, on devprof's two clocks: the
  least synced host wall of ``reps`` calls after a warm-up call, and the
  device time a call over ``reps`` more calls queued while the device
  spins (``devprof.device_clock_ms``).  The busy share is that device
  time over the wall when the calls were queued ahead; a call that waits
  on the device inside cannot be, and its time is then CUDA events with
  the host's gaps, printed as such and never as a busy share.  Returns
  ``{'wall_ms', 'device_ms', 'clock'}``."""
  fn()
  torch.cuda.synchronize()
  wall_ms = float('inf')
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = min(wall_ms, (time.perf_counter() - t0) * 1e3)
  dev_ms, clock = devprof.device_clock_ms(fn, reps, torch.device('cuda'),
                                          wall_ms)
  head = (f'[{tag}] {what}: wall {wall_ms:.3f} ms (host clock, synced, '
          f'least of {reps}); ')
  if clock == 'queued':
    log(head + f'device busy {dev_ms:.3f} ms a call (CUDA events, {reps} '
        f'calls queued ahead) = {100 * dev_ms / wall_ms:.1f} % of it')
  else:
    log(head + f'{dev_ms:.3f} ms a call on CUDA events with the host\'s '
        'gaps (the call waits on the device inside, so it cannot be '
        'queued ahead): not a busy share')
  return {'wall_ms': wall_ms, 'device_ms': dev_ms, 'clock': clock}


def phase_profile(model, numerical, cats):
  with torch.no_grad():
    profile_once(lambda: model(numerical, cats), 'profile', 'one forward')


def phase_serving(model, weights, cats, rng, table_dtype='auto',
                  tag='serving'):
  dist = model.dist_embedding
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  engine = ServingEngine(dist.table_configs, weights,
                         batch_size=SERVE_BATCH, device=dist.device,
                         input_table_map=model.input_table_map,
                         hotness=model.hotness, table_dtype=table_dtype)
  batch = np.asarray(cats[0]).shape[0]
  lookup.LAUNCHES = 0
  engine.warmup(sample_cats=[c[:SERVE_BATCH] for c in cats])
  warm_launches = lookup.LAUNCHES
  warm_lookups = engine.stats()['batches_served']
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  answers = []
  request_ms = {}
  for n in REQUEST_SIZES:
    times = []
    for _ in range(5):
      start = int(rng.integers(0, batch - n + 1))
      req = [c[start:start + n] for c in cats]
      t0 = time.perf_counter()
      got = engine.lookup_padded(req)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      answers.append((req, got))
    request_ms[n] = times
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  lookups = engine.stats()['batches_served'] - warm_lookups
  if launches != {'lookup_combine': lookups * n_subs, 'segwalk_apply': 0}:
    raise AssertionError(f'serving launched {launches} for {lookups} '
                         f'lookups x {n_subs} subgroups')
  with torch.no_grad():
    for req, got in answers:
      want = dist.apply(model.embedding_params, req)
      for i, (g, w, h) in enumerate(zip(got, want, model.hotness)):
        same = (torch.equal(g, w) if h == 1 else
                torch.allclose(g, w, rtol=1e-6, atol=1e-6))
        if not same:
          raise AssertionError(f'request of {len(req[0])}: input {i} '
                               'differs from the model lookup')
  for n, times in request_ms.items():
    log(f'[{tag}] request of {n} samples: ms {[round(t, 3) for t in times]}'
        f' median {statistics.median(times):.3f} (host clock, '
        'synchronised; pad + copy + lookup)')
  log(f'[{tag}] stats {json.dumps(engine.stats())}')
  log(f'[{tag}] {len(answers)} answers equal the model lookup '
      '(bit-exact hotness 1, 1e-6 hotness 10); kernel launches '
      f'{json.dumps(launches)}: {lookups} request lookups x {n_subs} '
      f'subgroups, after {warm_launches} in the warm-up of {warm_lookups} '
      'rungs')
  return launches


def train_batches(config, hotness, seed, n):
  """``n`` distinct batches of the power-law pool, multi-hot rows
  -1-padded as in the forward: ``(cats, (numerical, labels))``."""
  rng = np.random.default_rng(seed)
  pool = InputGenerator(config, BATCH, alpha=1.05, num_batches=n,
                        seed=seed)
  return [(pad_multi_hot(cats, hotness, rng), (numerical, labels))
          for (numerical, cats), labels in pool]


def tiny_head_loss(model):
  """The synthetic model's head and mean BCE, as the hybrid step takes
  it."""
  def head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(model.head(numerical, emb_outs,
                                           dense_params), labels)
  return head_loss


def build_trainer(model, emb_opt=None):
  """The JAX bench's training configuration on the port: SparseAdagrad
  (dedup; ``emb_opt`` in its place) for the tables, optax-style Adagrad
  for the MLP, mean BCE."""
  dist = model.dist_embedding
  dense_opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)
  emb_opt = emb_opt or sparse.SparseAdagrad(learning_rate=LR)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': model.embedding_params, **model.dense_params()},
      dense_opt, emb_opt)
  return sparse.make_hybrid_train_step(dist, tiny_head_loss(model),
                                       dense_opt, emb_opt), state


def captured_applies(step, state, cats, batch):
  """One real training step that also records each group's apply inputs
  (the table and accumulator cloned before the in-place update)."""
  calls = []
  apply = segwalk.segwalk_apply

  def record(table, acc, ids, grads, lr, *, op, eps=1e-7, g_index=None):
    calls.append({'table': table.clone(),
                  'acc': None if acc is None else acc.clone(), 'ids': ids,
                  'grads': grads, 'g_index': g_index, 'lr': lr, 'eps': eps,
                  'op': op})
    return apply(table, acc, ids, grads, lr, op=op, eps=eps,
                 g_index=g_index)

  segwalk.segwalk_apply = record
  try:
    state, loss = step(state, cats, batch)
  finally:
    segwalk.segwalk_apply = apply
  return state, loss, calls


def phase_train(model, config, seed):
  dist = model.dist_embedding
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  # the warm-up step's batch, the counted steps', then the capture
  # step's (phase 8) and the profiled step's (phase 9)
  batches = train_batches(config, model.hotness, seed + 1, TRAIN_STEPS + 3)
  step, state = build_trainer(model)
  torch.cuda.synchronize()
  log(f'[train] state: tables {model.total_table_gib():.3f} GiB + '
      f'Adagrad accumulators; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB')
  state, launches, times, _ = timed_steps(
      'train', step, state, batches,
      {'segwalk_apply': TRAIN_STEPS * n_groups,
       'lookup_combine': TRAIN_STEPS * n_subs})
  state, loss, calls = captured_applies(step, state,
                                        *batches[TRAIN_STEPS + 1])
  if not bool(torch.isfinite(loss)):
    raise AssertionError(f'capture step loss {float(loss)} not finite')
  return step, state, calls, batches[-1], launches, times


def segwalk_bound(segs, grads, table, acc, op):
  """``(bytes, bound_ms, bound_by)`` of one apply: each position's id
  and gradient-row index read once, each compact gradient row read once
  (2 B an element for a bf16 stream), each touched table and state row
  read and written once (a bf16 accumulator at 2 B an element; Adam's m
  and v at 4 B and its count at 4 B a row); f32 operations per summed
  element and per updated element."""
  n, u, w = segs.sorted_ids.shape[0], segs.count, table.shape[1]
  valid = int((segs.ends - segs.starts).sum())
  if op == 'adam':
    state_bytes, row_bytes, ops = 8, 4, 13
  else:
    state_bytes, row_bytes, ops = (
        0 if acc is None else acc.element_size(), 0, 6)
  row_rw = 2 * (w * (table.element_size() + state_bytes) + row_bytes)
  nbytes = n * 4 + n * 4 + grads.shape[0] * w * grads.element_size() + \
      u * row_rw
  flops = valid * w * (1 if op != 'adagrad_sq' else 3) + u * w * ops
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / F32_FLOP_PER_S * 1e3
  return (nbytes, max(bytes_ms, ops_ms),
          'bytes' if bytes_ms >= ops_ms else 'operations')


def check_segwalk(call, op, table, label):
  """Kernel against plain version on one captured stream (clones of its
  table and accumulator), with the timings and the bound."""
  lr, eps = call['lr'], call['eps']
  acc = None if op == 'sgd' else call['acc']
  ids, grads, g_index = call['ids'], call['grads'], call['g_index']
  rows, w = table.shape
  segs = segwalk.sort_stream(ids, rows, g_index)
  kt = table.clone()
  ka = None if acc is None else acc.clone()
  segwalk.apply_segments(kt, ka, segs, grads, lr, op=op, eps=eps)
  pt = table.clone()
  pa = None if acc is None else acc.clone()
  plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
      pt, pa, segs, grads, lr, op=op, eps=eps))
  err = float((kt.float() - pt.float()).abs().max())
  if acc is not None:
    err = max(err, float((ka - pa).abs().max()))
  if op == 'sgd':
    ok, tol = torch.equal(kt, pt), 'bit-exact'
  else:
    ok = (torch.allclose(kt.float(), pt.float(), rtol=1e-6, atol=1e-6)
          and torch.allclose(ka, pa, rtol=1e-6, atol=1e-6))
    tol = 'rtol=atol=1e-6 (rsqrt)'
  if not ok:
    raise AssertionError(f'{label}: kernel disagrees with plain version, '
                         f'max abs err {err} (tolerance {tol})')
  # rows the stream does not name stay bitwise unchanged
  touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
  touched[segs.sorted_ids[segs.starts].long()] = True
  changed = (kt != table).any(dim=1)
  if acc is not None:
    changed |= (ka != acc).any(dim=1)
  if bool((changed & ~touched).any()):
    raise AssertionError(f'{label}: the kernel changed rows outside the '
                         'stream')
  del pt, pa
  kernel_ms = device_ms(
      lambda: segwalk.apply_segments(kt, ka, segs, grads, lr, op=op,
                                     eps=eps), 10)
  library_ms = None
  if op == 'sgd':
    # Tensor.index_add_: the one PyTorch call computing the sgd apply
    lo, hi = int(segs.starts[0]), int(segs.ends[-1])
    lib_ids = segs.sorted_ids[lo:hi].long()
    lib_g = grads[segs.gidx[lo:hi].long()]
    library_ms = device_ms(
        lambda: kt.index_add_(0, lib_ids, lib_g.to(kt.dtype), alpha=-lr), 10)
    del lib_ids, lib_g
  n, m, u = ids.shape[0], grads.shape[0], segs.count
  valid = int((segs.ends - segs.starts).sum())
  nbytes, bound_ms, bound_by = segwalk_bound(segs, grads, table, acc, op)
  row = {
      'stream': label, 'op': op,
      'dtype': str(table.dtype).replace('torch.', ''), 'rows': rows,
      'w': w, 'positions': n, 'valid_positions': valid,
      'compact_grad_rows': m, 'segments': u,
      'longest_segment': segs.longest(), 'chunk': segwalk.CHUNK,
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': tol, 'kernel_ms': kernel_ms,
      'plain_ms': plain_ms, 'library_ms': library_ms,
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
  }
  log('[segwalk] ' + json.dumps(clocked(row)))
  del kt, ka
  torch.cuda.empty_cache()
  return row


def order_timings(call, label, order):
  """Kernel device time of each op in ``order`` on one captured stream,
  one after the other on the same clones, after one untimed warm-up
  apply of the first."""
  segs = segwalk.sort_stream(call['ids'], call['table'].shape[0],
                             call['g_index'])
  kt, ka = call['table'].clone(), call['acc'].clone()

  def apply(op):
    segwalk.apply_segments(kt, None if op == 'sgd' else ka, segs,
                           call['grads'], call['lr'], op=op, eps=call['eps'])

  apply(order[0])
  torch.cuda.synchronize()
  times = {op: device_ms(lambda: apply(op), 10, warmup=0) for op in order}
  log(f'[segwalk] {label} order {" -> ".join(order)}: kernel ms '
      f'{json.dumps(times)}')
  del kt, ka
  torch.cuda.empty_cache()
  return times


def phase_segwalk(calls):
  rows = []
  for call in calls:
    label = f'w{call["table"].shape[1]}_rows{call["table"].shape[0]}'
    if call['op'] != 'adagrad_dedup':
      raise AssertionError(f'the training path applies adagrad_dedup, '
                           f'captured {call["op"]}')
    for op in HYBRID_OPS:
      rows.append(check_segwalk(call, op, call['table'], label))
    # is an op's time a matter of its place in the sequence?
    for order in (HYBRID_OPS, HYBRID_OPS[1:] + HYBRID_OPS[:1]):
      order_timings(call, label, order)
  # one bf16 table: the largest group's, cast
  call = max(calls, key=lambda c: c['table'].numel())
  label = f'w{call["table"].shape[1]}_rows{call["table"].shape[0]}_bf16'
  bf16_row = check_segwalk(call, 'adagrad_dedup',
                           call['table'].to(torch.bfloat16), label)
  for r in rows + [bf16_row]:
    log(f'[segwalk] {r["stream"]} {r["op"]} {r["dtype"]}: kernel '
        f'{r["kernel_ms"]:.4f} ms, plain {r["plain_ms"]:.3f} ms (one '
        f'call), library {r["library_ms"]}, bound {r["bound_ms"]:.4f} ms; '
        f'{r["segments"]} segments, longest {r["longest_segment"]}, '
        f'{r["chunks"]} chunks of {r["chunk"]}')
  log('[segwalk] Tensor.index_add_ is the library time for sgd; no '
      'PyTorch call computes the Adagrad applies (library null)')
  return rows, bf16_row


def host_syncs(fn):
  """The host syncs of one call of ``fn`` that torch's sync debug mode
  sees (a prototype: it does not see every synchronising operation), by
  the Python line that made them."""
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  return collections.Counter(
      f'{pathlib.Path(w.filename).name}:{w.lineno}' for w in caught
      if 'called a synchronizing' in str(w.message))


def phase_train_profile(step, state, batch, tag='profile-train'):
  """``profile_once`` of a training step, then the host syncs of one more
  step; returns the profile with ``host_syncs``."""
  losses = []
  prof = profile_once(lambda: losses.append(step(state, *batch)[1]),
                      tag, 'one training step')
  syncs = host_syncs(lambda: losses.append(step(state, *batch)[1]))
  if not all(bool(torch.isfinite(x)) for x in losses):
    raise AssertionError('profiled step loss not finite')
  log(f'[{tag}] host syncs in one more step (sync debug mode): '
      f'{sum(syncs.values())}, by line '
      f'{json.dumps(dict(syncs.most_common()))}')
  return dict(prof, host_syncs=sum(syncs.values()))


def dlrm_batches(model, seed, n):
  """``n`` batches of the learnable power-law split at the model's
  vocabularies (``utils.data.generate_split``, alpha 3.0, 13 numerical
  features), the categorical inputs in worker order: ``(cats,
  (numerical, labels))``."""
  rng = np.random.default_rng(seed)
  plan = model.dist_embedding.plan
  order = [i for dev in plan.input_ids_list for i in dev]
  return [([cats[i].astype(np.int32) for i in order],
           (numerical.astype(np.float32),
            labels.astype(np.float32)[:, None]))
          for labels, numerical, cats in data.generate_split(
              rng, model.table_sizes, n * BATCH, DLRM_ALPHA, 13,
              chunk=BATCH)]


def input_order(model, cats):
  """Worker-order inputs back in input order."""
  order = [i for dev in model.dist_embedding.plan.input_ids_list
           for i in dev]
  pos = {i: k for k, i in enumerate(order)}
  return [cats[pos[i]] for i in range(len(order))]


def phase_dlrm_model(seed):
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = dlrm.DLRM(data.MLPERF_SIZES, embedding_dim=128,
                    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                    dp_input=False, dist_strategy='memory_balanced',
                    device='cuda').init(seed)
  torch.cuda.synchronize()
  dist = model.dist_embedding
  log(f'[dlrm] {len(data.MLPERF_SIZES)} tables at the MLPerf Criteo-1TB '
      f'sizes, {sum(data.MLPERF_SIZES):,} rows x 128, bf16: '
      f'{model.total_table_gib():.3f} GiB, drawn on the card in '
      f'{time.perf_counter() - t0:.2f} s; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during the '
      'draw')
  log(f'[dlrm] plan: {len(dist.plan.groups)} group(s) '
      f'{[(g.width, g.rows_cap, g.combiner) for g in dist.plan.groups]} '
      '(width, rows_cap, combiner); dp_input=False, bf16 compute; MLPs '
      f'{model.bottom_mlp.dims} and {model.top_mlp.dims}')
  return model


def phase_dlrm_forward(model, numerical, cats, n_forwards=3, n_check=512):
  """The example model's forward in model-parallel input mode: one
  lookup launch per forward; the first ``n_check`` samples' embedding
  outputs equal an independent gather bit for bit, and their logits the
  head's on those outputs."""
  dist = model.dist_embedding
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times = []
  with torch.no_grad():
    for _ in range(n_forwards):
      t0 = time.perf_counter()
      logits = model(numerical, cats)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if launches != {'lookup_combine': n_forwards, 'segwalk_apply': 0}:
    raise AssertionError(f'dlrm forward launched {launches}, expected '
                         f'{n_forwards} lookups')
  if tuple(logits.shape) != (BATCH, 1) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f'dlrm logits {tuple(logits.shape)} not finite '
                         f'or not [{BATCH}, 1]')
  weights = checkpoint.get_weights(dist, model.embedding_params)
  head = [c[:n_check] for c in cats]
  with torch.no_grad():
    outs = dist.apply(model.embedding_params, head)
    ref = plain_embedding_outputs(weights, dist.plan.input_table_map,
                                  input_order(model, head), n_check)
    for i, (o, r) in enumerate(zip(outs, ref)):
      if not torch.equal(o.float(), r.to(o.dtype).float()):
        raise AssertionError(f'dlrm input {i}: forward != plain gather')
    ref_logits = model.head(model.dense_params(), numerical[:n_check],
                            [r.to(torch.bfloat16) for r in ref])
    if not torch.equal(model(numerical[:n_check], head), ref_logits):
      raise AssertionError('dlrm logits disagree with the head on the '
                           'plain gather')
    # the same samples inside the full batch: other GEMM shapes, bf16
    err = float((logits[:n_check] - ref_logits).abs().max())
    if not torch.allclose(logits[:n_check], ref_logits, rtol=2e-2,
                          atol=2e-2):
      raise AssertionError(f'dlrm batch logits off the slice by {err}')
  log(f'[dlrm] forward, batch {BATCH}: ms {[round(t, 3) for t in times]} '
      f'(host clock, synchronised); launches {json.dumps(launches)}; '
      f'logits finite; first {n_check} samples equal a plain gather and '
      f'the head on it, within {err:.3g} of the full batch (bf16 GEMMs '
      'at another shape; bound 2e-2)')
  return launches


def dlrm_trainer(model):
  """``examples/dlrm/main.py``'s sparse trainer (SparseSGD(24) on the
  tables, SGD on the MLPs, both on the warm-up + poly-decay schedule,
  mean BCE), called as ``step(state, cats, (numerical, labels))``."""
  step, state = dlrm_main.make_trainer(model, 'sparse', 24.0)
  return (lambda state, cats, batch: step(state, batch[0], cats, batch[1]),
          state)


def phase_dlrm_train(model, batches):
  step, state = dlrm_trainer(model)
  state, launches, times, _ = timed_steps(
      'dlrm-train', step, state, batches,
      {'lookup_combine': TRAIN_STEPS, 'segwalk_apply': TRAIN_STEPS})
  return step, state, launches, times


def state_rows(acc, idx):
  """Rows ``idx`` of an optimizer state: None, an accumulator or Adam's
  ``Moments`` (a copy)."""
  if acc is None:
    return None
  if isinstance(acc, segwalk.Moments):
    return segwalk.Moments(*(x[idx] for x in acc))
  return acc[idx]


def state_clone(acc):
  if isinstance(acc, segwalk.Moments):
    return segwalk.Moments(*(x.clone() for x in acc))
  return None if acc is None else acc.clone()


def state_equal(a, b):
  if a is None:
    return b is None
  if isinstance(a, segwalk.Moments):
    return all(torch.equal(x, y) for x, y in zip(a, b))
  return torch.equal(a, b)


def captured_compact_applies(step, state, cats, batch, n_sample=1 << 20):
  """One real training step that also records its applies: each stream,
  and before the in-place update a compact copy of the rows it touches
  and a sample of ``n_sample`` rows it does not, of the table and of the
  optimizer state (no table is cloned whole)."""
  calls = []
  apply = segwalk.segwalk_apply

  def record(table, acc, ids, grads, lr, *, op, eps=1e-7, g_index=None,
             betas=segwalk.BETAS):
    rows = table.shape[0]
    touched = torch.unique(ids[(ids >= 0) & (ids < rows)])
    gen = torch.Generator(device=table.device).manual_seed(0)
    sample = torch.randint(0, rows, (n_sample,), device=table.device,
                           generator=gen, dtype=torch.int64)
    sample = sample[~torch.isin(sample, touched.long())]
    calls.append({'table': table, 'acc': acc, 'ids': ids, 'grads': grads,
                  'g_index': g_index, 'lr': lr, 'eps': eps, 'op': op,
                  'betas': betas, 'touched': touched,
                  'compact': table[touched.long()],
                  'compact_acc': state_rows(acc, touched.long()),
                  'sample': sample, 'before': table[sample],
                  'before_acc': state_rows(acc, sample)})
    return apply(table, acc, ids, grads, lr, op=op, eps=eps,
                 g_index=g_index, betas=betas)

  segwalk.segwalk_apply = record
  try:
    state, loss = step(state, cats, batch)
  finally:
    segwalk.segwalk_apply = apply
  return state, loss, calls


def compact_applies(call, op, grads):
  """The kernel and the plain version on compact copies of the rows the
  captured stream touches (its ids remapped in order: the same sorted
  stream, the same summation order): ``[(table, state)] * 2``."""
  ids, touched, rows = call['ids'], call['touched'], call['table'].shape[0]
  u = touched.shape[0]
  valid = (ids >= 0) & (ids < rows)
  cids = torch.where(valid, torch.searchsorted(touched, ids).to(torch.int32),
                     torch.full_like(ids, u))
  csegs = segwalk.sort_stream(cids, u, call['g_index'])
  acc = None if op == 'sgd' else call['compact_acc']
  out = []
  for fn in (segwalk.apply_segments, segwalk.apply_segments_reference):
    t, a = call['compact'].clone(), state_clone(acc)
    fn(t, a, csegs, grads, call['lr'], op=op, eps=call['eps'],
       betas=call['betas'])
    out.append((t, a))
  torch.cuda.synchronize()
  return out


def timed_steps(tag, step, state, batches, want, n_steps=TRAIN_STEPS,
                losses_out=None):
  """One warm-up step on ``batches[0]``, then ``n_steps`` timed ones on
  the next batches, the launch counts set to 0 just before them and
  read just after: every loss finite, the launches (kernels and arms) as
  ``want``, the peak device memory below the card's.  Returns ``(state,
  launches, times, peak)``; every loss, the warm-up's first, is appended
  to ``losses_out`` where one is given."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state, loss = step(state, *batches[0])
  torch.cuda.synchronize()
  if losses_out is not None:
    losses_out.append(loss.detach().clone())
  log(f'[{tag}] warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} ms, '
      f'loss {float(loss):.6f}')
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  segwalk.ARM_LAUNCHES.clear()
  times, losses = [], []
  for batch in batches[1:n_steps + 1]:
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
    if losses_out is not None:
      losses_out.append(loss.detach().clone())
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES,
              **{f'segwalk_apply:{arm}': n
                 for arm, n in sorted(segwalk.ARM_LAUNCHES.items())}}
  if not all(np.isfinite(losses)):
    raise AssertionError(f'{tag}: losses not finite: {losses}')
  if launches != want:
    raise AssertionError(f'{tag}: launched {launches}, expected {want}')
  peak = torch.cuda.max_memory_allocated()
  total = torch.cuda.get_device_properties(0).total_memory
  if peak >= total:
    raise AssertionError(f'{tag}: peak {peak} B above the card\'s {total} B')
  med = statistics.median(times)
  log(f'[{tag}] batch {BATCH}: {n_steps} steps, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised), median '
      f'{med:.3f} = {BATCH / med * 1e3:,.0f} samples/s; losses '
      f'{[round(x, 6) for x in losses]}')
  log(f'[{tag}] launches {json.dumps(launches)}; peak device memory '
      f'{peak / 2**30:.3f} GiB of the card\'s {total / 2**30:.3f} GiB')
  return state, launches, times, peak


def check_compact(call, op, grads, label, stepped=None):
  """The kernel against its plain version on compact copies of one
  captured stream's touched rows (``compact_applies``): sgd bit-exact;
  the Adagrad ops rtol = atol = 1e-6 on table and accumulator; adam its
  step counts exact, its moments bit-exact (no pow in them) and its table
  rtol = atol = 1e-6.  With ``stepped`` (the rows and state the real
  step wrote), the kernel's equal them bit for bit.  Returns the max abs
  error and the tolerance."""
  (kt, ka), (pt, pa) = compact_applies(call, op, grads)
  err = float((kt.float() - pt.float()).abs().max())
  if op == 'sgd':
    ok, tol = torch.equal(kt, pt), 'bit-exact'
  elif op == 'adam':
    err = max(err, float((ka.m - pa.m).abs().max()),
              float((ka.v - pa.v).abs().max()))
    ok = (torch.equal(ka.t, pa.t) and torch.equal(ka.m, pa.m)
          and torch.equal(ka.v, pa.v)
          and torch.allclose(kt.float(), pt.float(), rtol=1e-6, atol=1e-6))
    tol = 't, m, v bit-exact; table rtol=atol=1e-6 (powf)'
  else:
    err = max(err, float((ka.float() - pa.float()).abs().max()))
    ok = (torch.allclose(kt.float(), pt.float(), rtol=1e-6, atol=1e-6)
          and torch.allclose(ka.float(), pa.float(), rtol=1e-6, atol=1e-6))
    tol = 'rtol=atol=1e-6 (rsqrt)'
  if not ok:
    raise AssertionError(f'{label} {op}: kernel disagrees with the plain '
                         f'version, max abs err {err} ({tol})')
  if stepped is not None and not (torch.equal(kt, stepped[0])
                                  and state_equal(ka, stepped[1])):
    raise AssertionError(f'{label} {op}: the kernel on the compact copy '
                         'differs from what the step wrote')
  return err, tol


def check_untouched(call, label):
  """The sampled rows the captured stream does not name: the table's and
  the state's unchanged by the step."""
  table, acc, sample = call['table'], call['acc'], call['sample']
  if not (torch.equal(table[sample], call['before'])
          and state_equal(state_rows(acc, sample), call['before_acc'])):
    raise AssertionError(f'{label}: the step changed rows outside its '
                         'stream')


def plain_ms_of(fn) -> float:
  """CUDA-event time of one call of the plain version."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end)


def stream_row(call, op, grads, acc, label, err, tol, kernel_ms, plain_ms,
               library_ms, **extra):
  """One summary row of an apply on a captured stream, with its bound."""
  table = call['table']
  segs = segwalk.sort_stream(call['ids'], table.shape[0], call['g_index'])
  nbytes, bound_ms, bound_by = segwalk_bound(segs, grads, table, acc, op)
  n = segs.sorted_ids.shape[0]
  row = {
      'stream': label, 'op': op,
      'dtype': str(table.dtype).replace('torch.', ''),
      'stream_dtype': str(grads.dtype).replace('torch.', ''),
      'acc_dtype': (None if acc is None else 'float32' if isinstance(
          acc, segwalk.Moments) else str(acc.dtype).replace('torch.', '')),
      'rows': table.shape[0], 'w': table.shape[1], 'positions': n,
      'valid_positions': int((segs.ends - segs.starts).sum()),
      'compact_grad_rows': grads.shape[0], 'segments': segs.count,
      'longest_segment': segs.longest(), 'chunk': segwalk.CHUNK,
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': tol, 'kernel_ms': kernel_ms,
      'plain_ms': plain_ms, 'library_ms': library_ms, 'bound_ms': bound_ms,
      'bound_by': bound_by,
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9, **extra}
  return row, segs


def check_dlrm_segwalk(call):
  """The captured sgd stream: the kernel against its plain version on a
  compact copy of the touched rows (ids remapped in order, so the sorted
  stream and its summation order are the same), both against what the
  step wrote into the real table (bit-exact); the sampled untouched rows
  unchanged.  Kernel, plain and ``Tensor.index_add_`` timed on the real
  table at lr 0, which leaves it bitwise as it is (checked)."""
  table, grads, touched = call['table'], call['grads'], call['touched']
  rows, w = table.shape
  label = f'w{w}_rows{rows}'
  if call['op'] != 'sgd':
    raise AssertionError(f'the DLRM step applies sgd, captured {call["op"]}')
  check_untouched(call, 'dlrm')
  stepped = table[touched.long()]
  err, tol = check_compact(call, 'sgd', grads, 'dlrm', (stepped, None))
  segs = segwalk.sort_stream(call['ids'], rows, call['g_index'])
  kernel_ms = device_ms(lambda: segwalk.apply_segments(
      table, None, segs, grads, 0.0, op='sgd'), 10)
  plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
      table, None, segs, grads, 0.0, op='sgd'))
  lo, hi = int(segs.starts[0]), int(segs.ends[-1])
  lib_ids = segs.sorted_ids[lo:hi].long()
  lib_g = grads[segs.gidx[lo:hi].long()].to(table.dtype)
  library_ms = device_ms(lambda: table.index_add_(0, lib_ids, lib_g,
                                                  alpha=-0.0), 10)
  del lib_ids, lib_g
  if not torch.equal(table[touched.long()], stepped):
    raise AssertionError('dlrm: an apply at lr 0 changed the table')
  check_untouched(call, 'dlrm')
  row, _ = stream_row(call, 'sgd', grads, None, label, err, tol, kernel_ms,
                      plain_ms, library_ms,
                      untouched_rows_sampled=int(call['sample'].shape[0]))
  log('[dlrm-segwalk] ' + json.dumps(clocked(row)))
  torch.cuda.empty_cache()
  return row


def run_dlrm(seed, tiny_k, tiny_seg):
  """The DLRM phases: the example's model at the MLPerf table sizes in
  bf16, forward, kernels, training, the apply check and a profile.
  Adds a ``dlrm`` entry to each kernel's summary."""
  model = phase_dlrm_model(seed)
  # the forwards', the warm-up's, the timed steps', the capture step's
  # and the profiled steps' batches
  t0 = time.perf_counter()
  batches = dlrm_batches(model, seed + 2, TRAIN_STEPS + 4)
  log(f'[dlrm] {len(batches)} batches of {BATCH} drawn on the host in '
      f'{time.perf_counter() - t0:.2f} s (alpha {DLRM_ALPHA})')
  cats, (numerical, _) = batches[0]
  fwd_launches = phase_dlrm_forward(model, numerical, cats)
  (table, routed, combiner), = captured_lookups(model, numerical, cats)
  if combiner is not None:
    raise AssertionError(f'the DLRM tables combine with None, got '
                         f'{combiner}')
  lk = check_kernel_shape(table, routed.reshape(-1, 1),
                          f'dlrm_w128_h1_ncap{routed.shape[0]}_bf16')
  del table, routed
  step, state, launches, step_ms = phase_dlrm_train(model, batches[1:])
  state, loss, calls = captured_compact_applies(step, state,
                                                *batches[TRAIN_STEPS + 2])
  if not bool(torch.isfinite(loss)) or len(calls) != 1:
    raise AssertionError(f'capture step: loss {float(loss)}, '
                         f'{len(calls)} applies')
  sw = check_dlrm_segwalk(calls[0])
  del calls
  torch.cuda.empty_cache()
  phase_train_profile(step, state, batches[TRAIN_STEPS + 3])

  shape = lambda r, keys: {k: r[k] for k in keys}
  tiny_k['dlrm'] = {
      'launches': launches['lookup_combine'],
      'launches_forward': fwd_launches['lookup_combine'],
      'shape': shape(lk, ('M', 'h', 'w', 'dtype', 'distinct_rows')),
      'table_rows': sum(data.MLPERF_SIZES),
      'max_abs_err': lk['max_abs_err'], 'ms': lk['kernel_ms'],
      'plain_ms': lk['plain_ms'], 'bound_ms': lk['bound_ms'],
      'bound_by': lk['bound_by'], 'library_ms': lk['library_ms'],
  }
  tiny_seg['dlrm'] = {
      'launches': launches['segwalk_apply'],
      'launches_forward': fwd_launches['segwalk_apply'],
      'shape': shape(sw, ('op', 'dtype', 'rows', 'w', 'positions',
                          'segments', 'longest_segment', 'chunks')),
      'max_abs_err': sw['max_abs_err'], 'ms': sw['kernel_ms'],
      'plain_ms': sw['plain_ms'], 'bound_ms': sw['bound_ms'],
      'bound_by': sw['bound_by'], 'library_ms': sw['library_ms'],
  }
  log(f'[dlrm] lookup {lk["kernel_ms"]:.4f} ms (bound '
      f'{lk["bound_ms"]:.4f}, plain {lk["plain_ms"]:.3f}, embedding_bag '
      f'{lk["library_ms"]:.4f}); segment walk sgd {sw["kernel_ms"]:.4f} '
      f'ms (bound {sw["bound_ms"]:.4f}, plain {sw["plain_ms"]:.3f}, '
      f'index_add_ {sw["library_ms"]:.4f}); steps {step_ms}')


def captured_backward(step, state, *batch):
  """One real dense step that also records its lookup backwards (the
  arguments of every ``lookup.lookup_grad`` call: one per fusion
  group)."""
  calls = []
  fn = lookup.lookup_grad

  def record(ids, grads, combiners, vocab, dtype):
    calls.append({'ids': ids, 'grads': grads, 'combiners': combiners,
                  'vocab': vocab, 'dtype': dtype})
    return fn(ids, grads, combiners, vocab, dtype)

  lookup.lookup_grad = record
  try:
    state, loss = step(state, *batch)
  finally:
    lookup.lookup_grad = fn
  return state, loss, calls


# rows per block of the checks on table-shaped gradients, which make no
# table-sized temporary (the DLRM's is 12.9 GiB)
CHECK_BLOCK_ROWS = 1 << 22


def untouched_rows_zero(grad_table, touched):
  """Whether every row outside ``touched`` (a bool mask over the rows)
  is exactly zero."""
  for r0 in range(0, grad_table.shape[0], CHECK_BLOCK_ROWS):
    nonzero = (grad_table[r0:r0 + CHECK_BLOCK_ROWS] != 0).any(dim=1)
    if bool((nonzero & ~touched[r0:r0 + CHECK_BLOCK_ROWS]).any()):
      return False
  return True


def compare_tables(a, b):
  """``(equal, max abs difference)`` of two table-shaped tensors."""
  same, err = True, 0.0
  for r0 in range(0, a.shape[0], CHECK_BLOCK_ROWS):
    x, y = a[r0:r0 + CHECK_BLOCK_ROWS], b[r0:r0 + CHECK_BLOCK_ROWS]
    same = same and torch.equal(x, y)
    err = max(err, float((x.float() - y.float()).abs().max()))
  return same, err


def check_dense_grad(call, label):
  """The lookup's backward on one group's captured stream
  (``check_add_stream`` of its sorted stream and cotangent rows)."""
  segs, rows = lookup.grad_stream(call['ids'], call['grads'],
                                  call['combiners'], call['vocab'])
  return check_add_stream(segs, rows, call['vocab'], call['dtype'], label,
                          'dense-grad')


def check_add_stream(segs, rows, vocab, dtype, label, tag):
  """A segment sum into a zeroed ``[vocab, w]`` buffer at ``dtype``: the
  kernel's (a zero-fill, then the segment walk's 'add') against the
  plain version (bit-exact), rows no id names exactly zero; device
  times of the kernel's function, of its two parts, of the plain
  version (one call) and of ``Tensor.index_add_`` into a zero-fill (the
  library), beside the function's bound and the 'add''s own."""
  w = rows.shape[1]
  dev = rows.device

  def kernel():
    out = torch.zeros((vocab, w), dtype=dtype, device=dev)
    segwalk.apply_segments(out, None, segs, rows, 0.0, op='add')
    return out

  kt = kernel()
  pt = torch.zeros((vocab, w), dtype=dtype, device=dev)
  # the plain version's zero-fill is timed with it, as the kernel's is
  plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
      pt.zero_(), None, segs, rows, 0.0, op='add'))
  same, err = compare_tables(kt, pt)
  if not same:
    raise AssertionError(f'{label}: the backward kernel disagrees with the '
                         f'plain version, max abs err {err} (bit-exact)')
  del pt
  touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
  touched[segs.sorted_ids[segs.starts].long()] = True
  if not untouched_rows_zero(kt, touched):
    raise AssertionError(f'{label}: a row no id names has a gradient')
  add_ms = device_ms(lambda: segwalk.apply_segments(kt, None, segs, rows,
                                                    0.0, op='add'), 10)
  zero_ms = device_ms(kt.zero_, 10)
  del kt
  kernel_ms = device_ms(kernel, 10)
  lo, hi = int(segs.starts[0]), int(segs.ends[-1])
  lib_ids = segs.sorted_ids[lo:hi].long()
  lib_rows = rows[segs.gidx[lo:hi].long()].to(dtype)
  library_ms = device_ms(
      lambda: torch.zeros((vocab, w), dtype=dtype, device=dev).index_add_(
          0, lib_ids, lib_rows), 10)
  del lib_ids, lib_rows
  # the least bytes of the function: the stream's ids and row map and
  # its cotangent rows read once, the gradient written once; one f32 add
  # per valid element.  The 'add' alone reads and writes only the
  # touched rows, and adds each segment's sum into its row.
  n, m, u = segs.sorted_ids.shape[0], rows.shape[0], segs.count
  valid = int((segs.ends - segs.starts).sum())
  itemsize = torch.empty((), dtype=dtype).element_size()
  stream_bytes = n * 4 + n * 4 + m * w * 4
  nbytes = stream_bytes + vocab * w * itemsize
  add_bytes = stream_bytes + 2 * u * w * itemsize
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = valid * w / F32_FLOP_PER_S * 1e3
  add_bytes_ms = add_bytes / HBM_BYTES_PER_S * 1e3
  add_ops_ms = (valid + u) * w / F32_FLOP_PER_S * 1e3
  row = {
      'stream': label, 'op': 'add', 'dtype': str(dtype).replace('torch.', ''),
      'rows': vocab, 'w': w, 'positions': n, 'valid_positions': valid,
      'cotangent_rows': m, 'segments': u, 'longest_segment': segs.longest(),
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes, 'max_abs_err': err,
      'tolerance': 'bit-exact', 'kernel_ms': kernel_ms, 'add_ms': add_ms,
      'zero_fill_ms': zero_ms, 'plain_ms': plain_ms,
      'library_ms': library_ms, 'bound_ms': max(bytes_ms, ops_ms),
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
      'add_bytes': add_bytes, 'add_bound_ms': max(add_bytes_ms, add_ops_ms),
      'add_bound_by': 'bytes' if add_bytes_ms >= add_ops_ms else 'operations',
  }
  log(f'[{tag}] ' + json.dumps(clocked(row)))
  torch.cuda.empty_cache()
  return row


def phase_dense(tag, step, state, batches, per_step):
  """Phase 14 or 15: one warm-up dense step, ``TRAIN_STEPS`` timed ones
  (every loss finite, every lookup on the lookup kernel and every
  backward on the segment walk, ``per_step`` launches of each a step,
  peak memory below the card's), then one captured step whose table
  gradient of every group ``check_dense_grad`` holds to the plain
  version, then phase 16's profile and host syncs of one more step."""
  state, launches, times, peak = timed_steps(
      tag, step, state, batches,
      {k: TRAIN_STEPS * v for k, v in per_step.items()})
  state, loss, calls = captured_backward(step, state,
                                         *batches[TRAIN_STEPS + 1])
  if not bool(torch.isfinite(loss)) or len(calls) != per_step['segwalk_apply']:
    raise AssertionError(f'{tag}: capture step loss {float(loss)}, '
                         f'{len(calls)} backwards')
  grad_rows = []
  while calls:
    call = calls.pop(0)
    w = call['grads'][0].shape[1]
    grad_rows.append(check_dense_grad(call, f'{tag}_rows{call["vocab"]}_w{w}'))
    del call
  torch.cuda.empty_cache()
  # phase 16: the profile and the host syncs of one more step each
  losses = []
  profile_once(lambda: losses.append(step(state, *batches[-1])[1]),
               'dense-profile', f'{tag}: one dense step')
  syncs = host_syncs(lambda: losses.append(step(state, *batches[-1])[1]))
  if not all(bool(torch.isfinite(x)) for x in losses):
    raise AssertionError(f'{tag}: profiled step loss not finite')
  log(f'[dense-profile] {tag}: host syncs in one more step (sync debug '
      f'mode): {sum(syncs.values())}, by line '
      f'{json.dumps(dict(syncs.most_common()))}')
  return launches, grad_rows, peak, times


def dense_entry(launches, rows, keys, extra=None):
  """A kernel's ``dense`` entry of the summary line for one model: the
  times and bounds summed over ``rows`` (one per stream of a step), and
  each stream's ``keys``."""
  entry = {'launches': launches,
           'streams': [{k: r[k] for k in keys} for r in rows],
           'max_abs_err': max(r['max_abs_err'] for r in rows)}
  for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms'):
    entry[k] = sum(r['kernel_ms' if k == 'ms' else k] for r in rows)
  entry['bound_by'] = ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                       else 'operations')
  entry.update(extra or {})
  return entry


# each backward stream's shape and parts in the summary line
DENSE_GRAD_KEYS = ('stream', 'op', 'dtype', 'rows', 'w', 'positions',
                   'segments', 'longest_segment', 'add_ms', 'add_bound_ms',
                   'zero_fill_ms')


def run_dense_tiny(seed, lookup_k):
  """Phase 14 (and 16): the tiny model at full size trained by the dense
  autodiff step with dense Adagrad on every param (``optim.adagrad(0.01,
  0.1, 1e-7)``, mean BCE, ``dp_input=True``); returns the two kernels'
  ``dense`` entries for it.  ``lookup_k``: the lookup's summary from
  phase 4, whose shapes are this model's lookups'."""
  config = SYNTHETIC_MODELS[MODEL]
  model = SyntheticModel(config, dp_input=True, device='cuda').init(seed)
  dist = model.dist_embedding
  opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)

  def loss_fn(params, batch):
    cats, (numerical, labels) = batch
    return dlrm.bce_with_logits(model.apply(params, numerical, cats), labels)

  step = grad.make_train_step(loss_fn, opt)
  state = grad.init_train_state(
      {'embedding': model.embedding_params, **model.dense_params()}, opt)
  torch.cuda.synchronize()
  log(f'[dense-tiny] tables {model.total_table_gib():.3f} GiB f32 + '
      f'Adagrad sum of squares on every param; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB')
  batches = [(batch,) for batch in train_batches(
      config, model.hotness, seed + 3, TRAIN_STEPS + 3)]
  per_step = {'lookup_combine': len(dist._subgroups(tuple(model.hotness))),
              'segwalk_apply': len(dist.plan.groups)}
  launches, rows, peak, times = phase_dense('dense-tiny', step, state,
                                            batches, per_step)
  k = {'launches': launches['lookup_combine'],
       'shape': 'the forward\'s, timed in phase 4',
       **{key: lookup_k[key] for key in ('max_abs_err', 'ms', 'plain_ms',
                                         'library_ms', 'bound_ms',
                                         'bound_by')},
       'step_ms': times, 'peak_gib': peak / 2**30}
  seg = dense_entry(launches['segwalk_apply'], rows, DENSE_GRAD_KEYS)
  return k, seg


def run_dense_dlrm(seed):
  """Phase 15 (and 16): the DLRM of ``examples/dlrm/main.py --trainer
  dense`` (bf16, ``dp_input=False``, the MLPerf widths, every vocabulary
  capped at ``DENSE_DLRM_MAX_ROWS``) through the example's trainer;
  returns the two kernels' ``dense`` entries for it."""
  sizes = [min(s, DENSE_DLRM_MAX_ROWS) for s in data.MLPERF_SIZES]
  t0 = time.perf_counter()
  model = dlrm.DLRM(sizes, embedding_dim=128, param_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, dp_input=False,
                    dist_strategy='memory_balanced', device='cuda').init(seed)
  torch.cuda.synchronize()
  log(f'[dense-dlrm] {len(sizes)} tables, {sum(sizes):,} rows x 128 (the '
      f'MLPerf vocabularies capped at {DENSE_DLRM_MAX_ROWS:,}), bf16: '
      f'{model.total_table_gib():.3f} GiB, drawn in '
      f'{time.perf_counter() - t0:.2f} s')
  batches = dlrm_batches(model, seed + 4, TRAIN_STEPS + 3)
  (table, routed, _), = captured_lookups(model, batches[0][1][0],
                                         batches[0][0])
  lk = check_kernel_shape(table, routed.reshape(-1, 1),
                          f'dense_dlrm_w128_h1_ncap{routed.shape[0]}_bf16')
  del table, routed
  step, state = dlrm_main.make_trainer(model, 'dense', 24.0)
  batches = [(numerical, cats, labels)
             for cats, (numerical, labels) in batches]
  launches, rows, peak, times = phase_dense(
      'dense-dlrm', step, state, batches,
      {'lookup_combine': 1, 'segwalk_apply': 1})
  k = dense_entry(launches['lookup_combine'], [lk],
                  ('M', 'h', 'w', 'dtype', 'distinct_rows'),
                  {'table_rows': sum(sizes), 'step_ms': times,
                   'peak_gib': peak / 2**30})
  seg = dense_entry(launches['segwalk_apply'], rows, DENSE_GRAD_KEYS)
  return k, seg


def phase_tiny_adam(model, config, seed):
  """Lazy Adam on the tiny model already built: ``SparseAdam(0.001)`` on
  the tables (the segment walk's 'adam' op) and Adagrad on the MLP; one
  warm-up step and 3 timed steps; a sample of rows no step named keeps
  its weights bitwise and zero moments and count; then one more step's
  streams, the kernel against its plain version on compact copies of
  the touched rows and against what the step wrote."""
  dist = model.dist_embedding
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  dense_opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)
  emb_opt = sparse.SparseAdam(0.001)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': model.embedding_params, **model.dense_params()},
      dense_opt, emb_opt)
  step = sparse.make_hybrid_train_step(dist, tiny_head_loss(model),
                                       dense_opt, emb_opt)
  batches = train_batches(config, model.hotness, seed + 5, ADAM_STEPS + 2)
  # a sample of each group's rows, and every id the steps name
  gen = torch.Generator(device='cuda').manual_seed(seed)
  samples = {k: torch.randint(0, t.shape[0], (1 << 20,), device='cuda',
                              generator=gen)
             for k, t in model.embedding_params.items()}
  before = {k: model.embedding_params[k][x] for k, x in samples.items()}
  named = collections.defaultdict(list)
  apply = segwalk.segwalk_apply

  def record(table, acc, ids, *args, **kwargs):
    key = next(k for k, t in model.embedding_params.items() if t is table)
    named[key].append(ids)  # kept, not reduced: no host sync in the step
    return apply(table, acc, ids, *args, **kwargs)

  segwalk.segwalk_apply = record
  try:
    per_step = {'lookup_combine': n_subs, 'segwalk_apply': n_groups,
                'segwalk_apply:adam': n_groups}
    state, launches, times, peak = timed_steps(
        'tiny-adam', step, state, batches[:ADAM_STEPS + 1],
        {k: v * ADAM_STEPS for k, v in per_step.items()}, n_steps=ADAM_STEPS)
  finally:
    segwalk.segwalk_apply = apply
  opt_state = state.opt_state[1]
  cold_rows = 0
  for k, x in samples.items():
    cold = ~torch.isin(x, torch.cat(named[k]).long())
    st = opt_state[k]
    ok = (torch.equal(model.embedding_params[k][x[cold]], before[k][cold])
          and not st['m'][x[cold]].any() and not st['v'][x[cold]].any()
          and not st['t'][x[cold]].any()
          and bool((st['t'][x[~cold]] > 0).all()))
    if not ok:
      raise AssertionError(f'tiny-adam {k}: not lazy on the sampled rows')
    cold_rows += int(cold.sum())
  log(f'[tiny-adam] lazy: {cold_rows} sampled rows no step named kept '
      'their weights bitwise and m = v = t = 0; the named ones have t > 0')
  state, loss, calls = captured_compact_applies(step, state, *batches[-1])
  if not bool(torch.isfinite(loss)) or len(calls) != n_groups:
    raise AssertionError(f'tiny-adam capture step: loss {float(loss)}, '
                         f'{len(calls)} applies')
  rows = []
  for call in calls:
    table, grads = call['table'], call['grads']
    label = f'adam_w{table.shape[1]}_rows{table.shape[0]}'
    check_untouched(call, label)
    touched = call['touched'].long()
    err, tol = check_compact(call, 'adam', grads, label, stepped=(
        table[touched], state_rows(call['acc'], touched)))
    segs = segwalk.sort_stream(call['ids'], table.shape[0], call['g_index'])
    # timed on the real state (it is not used after this phase)
    kernel_ms = device_ms(lambda: segwalk.apply_segments(
        table, call['acc'], segs, grads, call['lr'], op='adam',
        eps=call['eps'], betas=call['betas']), 10)
    plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
        table, call['acc'], segs, grads, call['lr'], op='adam',
        eps=call['eps'], betas=call['betas']))
    row, _ = stream_row(call, 'adam', grads, call['acc'], label, err, tol,
                        kernel_ms, plain_ms, None)
    log('[tiny-adam] ' + json.dumps(clocked(row)))
    rows.append(row)
  del calls
  torch.cuda.empty_cache()
  log('[tiny-adam] no PyTorch call computes lazy Adam with a per-row step '
      'count (library null)')
  return launches, rows, times


def reset_launches():
  lookup.LAUNCHES = 0
  lookup.ARM_LAUNCHES.clear()
  segwalk.LAUNCHES = 0
  segwalk.ARM_LAUNCHES.clear()


def read_launches():
  return {'lookup_combine': lookup.LAUNCHES,
          'segwalk_apply': segwalk.LAUNCHES}


def check_disk(need_bytes, tag):
  """The free space under ``CKPT_DIR``, logged; too little fails the
  phase with the numbers."""
  CKPT_DIR.mkdir(parents=True, exist_ok=True)
  free = shutil.disk_usage(CKPT_DIR).free
  log(f'[{tag}] free disk under {CKPT_DIR}: {free / 1e9:.1f} GB; this '
      f'phase needs {need_bytes / 1e9:.1f} GB')
  if free < need_bytes:
    raise AssertionError(f'{tag}: {free / 1e9:.1f} GB free under '
                         f'{CKPT_DIR}, the phase needs '
                         f'{need_bytes / 1e9:.1f} GB for its checkpoints')


def metric_ms(name):
  """``(count, total ms)`` of one registry histogram."""
  h = obs_metrics.snapshot().get(name)
  return (0, 0.0) if h is None else (h['count'], h['sum'])


def logical_digests(dist, state):
  """The audit digests of a hybrid state's logical content: every table
  and sparse-optimizer leaf in the global layout (``get_weights``: views
  of the group tables, without the padding rows, which a restore
  zero-fills), the dense params and optimizer state, the step."""
  return audit.tree_digests({
      'tables': checkpoint.get_weights(dist, state.params['embedding']),
      'sparse': checkpoint.get_optimizer_state(dist, state.opt_state[1]),
      'dense': {k: v for k, v in state.params.items() if k != 'embedding'},
      'dense_opt': state.opt_state[0], 'step': state.step})


def compare_digests(tag, want, got):
  if got != want:
    bad = sorted(k for k in set(want) | set(got)
                 if want.get(k) != got.get(k))
    raise AssertionError(f'{tag}: state differs from run A in {bad}')


def phase_fit_tiny(model, config, seed):
  """Runs A, B and C of phase 9c; returns each run's launches and the
  save, restore, audit and step numbers."""
  dist = model.dist_embedding
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  per_step = {'lookup_combine': n_subs, 'segwalk_apply': n_groups}
  batches = train_batches(config, model.hotness, seed + 9, FIT_STEPS + 1)
  spare = batches.pop()  # for the host-sync count after run A
  big = max(model.embedding_params,
            key=lambda k: model.embedding_params[k].numel())
  # the big group's rows in use (the rest pad it and never train)
  used = sum(lt.input_dim for lt in dist.plan.groups[
      int(big.split('_')[1])].member_tables[0])
  state_bytes = 2 * sum(t.numel() * 4
                        for t in model.embedding_params.values())
  check_disk(2.5 * state_bytes, 'fit-tiny')
  shutil.rmtree(CKPT_DIR / 'fit', ignore_errors=True)
  dir_b, dir_c = CKPT_DIR / 'fit' / 'b', CKPT_DIR / 'fit' / 'c'
  dir_b.mkdir(parents=True)
  dir_c.mkdir(parents=True)

  def run(tag, want_steps, wrap=lambda s: s, data_=None, **fit_kw):
    """One fit from tables and MLP drawn anew from the seed."""
    model.embedding_params = {}
    gc.collect()
    torch.cuda.empty_cache()
    model.init(seed + 9)
    step, state = build_trainer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = grad.fit(wrap(step), state, iter(data_ or batches),
                           steps=FIT_STEPS, log_every=3, verbose=False,
                           dist=dist, **fit_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {k: v * want_steps for k, v in per_step.items()}
    if launches != want:
      raise AssertionError(f'fit-tiny {tag}: launched {launches}, expected '
                           f'{want} ({want_steps} steps)')
    digests = logical_digests(dist, state)
    log(f'[fit-tiny] run {tag}: {want_steps} steps in {wall:.2f} s, '
        f'losses {hist["loss"]}, launches {json.dumps(launches)}, peak '
        f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
    return step, state, hist, digests, launches

  # run A: uninterrupted, each step timed (synchronised)
  times = []

  def timed(step):
    def run_step(state, *args):
      t0 = time.perf_counter()
      out = step(state, *args)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      return out
    return run_step

  step, state, hist_a, dig_a, launch_a = run('A', FIT_STEPS, wrap=timed)
  peak_a = torch.cuda.max_memory_allocated()
  full_a = state.params['embedding'][big][:used].clone()
  bare = host_syncs(lambda: step(state, *spare))
  in_fit = host_syncs(lambda: grad.fit(step, state, iter([spare]),
                                       log_every=1, verbose=False))
  log(f'[fit-tiny] run A step times (synchronised) ms '
      f'{[round(t, 3) for t in times]}, median '
      f'{statistics.median(times):.3f} (phase 7 times the same step); '
      f'host syncs of one step: bare {sum(bare.values())}, inside fit '
      f'(log_every=1) {sum(in_fit.values())}')
  if sum(in_fit.values()) != sum(bare.values()) + 1:
    raise AssertionError(f'fit-tiny: fit added {dict(in_fit - bare)} '
                         'host syncs to a step, one (the loss window) '
                         'expected')
  del step, state

  # run B: checkpoint at step 3, NaN in an accumulator after step 4,
  # found by the audit, rolled back in place and replayed
  obs_metrics.enable()
  obs_metrics.reset()
  calls = [0]

  def poisoned(step):
    def run_step(state, *args):
      state, loss = step(state, *args)
      calls[0] += 1
      if calls[0] == 4:
        state.opt_state[1][big]['acc'][12_345, 0] = float('nan')
      return state, loss
    return run_step

  def keep_step3(s, state, logs):
    # run C resumes from this file; run B's retention prunes it at step 6
    if s == 3 and 'checkpoint' in logs:
      os.link(logs['checkpoint'], dir_c / 'ckpt_3.npz')

  cb = callbacks.CheckpointCallback(dist, str(dir_b / 'ckpt_{step}.npz'),
                                    every=3, keep_last=1)
  auditor = audit.StateAuditor(dist, every=1, bytes_per_audit=None)
  audit_ms = []  # each call's host time (it ends in a host sync)
  check_state = auditor.check_state

  def timed_check(state, step=None):
    t0 = time.perf_counter()
    findings = check_state(state, step=step)
    audit_ms.append((time.perf_counter() - t0) * 1e3)
    return findings

  auditor.check_state = timed_check
  _, state, hist_b, dig_b, launch_b = run(
      'B', FIT_STEPS + 1, wrap=poisoned, callbacks=[cb, keep_step3],
      on_anomaly='rollback', rollback_dir=str(dir_b),
      data_factory=lambda s: iter(batches[s:]), auditor=auditor)
  if hist_b.get('anomalies') != [{'kind': 'audit_failure', 'step': 4}]:
    raise AssertionError(f'fit-tiny B: anomalies {hist_b.get("anomalies")}')
  if sorted(os.listdir(dir_b)) != ['ckpt_6.npz']:
    raise AssertionError(f'fit-tiny B: {sorted(os.listdir(dir_b))} left')
  compare_digests('fit-tiny B', dig_a, dig_b)
  if hist_b['loss'] != hist_a['loss'] or not torch.equal(
      state.params['embedding'][big][:used], full_a):
    raise AssertionError(f'fit-tiny B: losses {hist_b["loss"]} against '
                         f'{hist_a["loss"]}, or the {big} table differs')
  file_bytes = os.path.getsize(dir_c / 'ckpt_3.npz')
  saves = metric_ms('ckpt.save_ms')
  restore_b = metric_ms('ckpt.restore_ms')
  del state
  shutil.rmtree(dir_b)

  # run C: a fresh draw resumed from the step-3 file
  obs_metrics.reset()
  _, state, hist_c, dig_c, launch_c = run(
      'C', FIT_STEPS - 3, data_=batches[3:], resume_from=str(dir_c))
  restore_c = metric_ms('ckpt.restore_ms')
  obs_metrics.disable()
  compare_digests('fit-tiny C', dig_a, dig_c)
  if hist_c['loss'] != hist_a['loss'][1:] or not torch.equal(
      state.params['embedding'][big][:used], full_a):
    raise AssertionError(f'fit-tiny C: losses {hist_c["loss"]} against '
                         f'{hist_a["loss"][1:]}, or the {big} table '
                         'differs')
  del state, full_a
  shutil.rmtree(CKPT_DIR / 'fit')
  save_s = saves[1] / 1e3 / saves[0]
  numbers = {
      'file_bytes': file_bytes, 'saves': saves[0], 'save_s': save_s,
      'save_gb_per_s': file_bytes / 1e9 / save_s,
      'restore_s': {'rollback': restore_b[1] / 1e3,
                    'resume': restore_c[1] / 1e3},
      # the 4th call found the NaN (and localized it); the others swept a
      # healthy state
      'audit_ms': audit_ms,
      'audit_ms_healthy_median': statistics.median(
          audit_ms[:3] + audit_ms[4:]),
      'step_ms': times, 'peak_gib': peak_a / 2**30,
      'host_syncs': {'bare_step': sum(bare.values()),
                     'fit_step': sum(in_fit.values())},
  }
  numbers['restore_gb_per_s'] = {
      k: file_bytes / 1e9 / v for k, v in numbers['restore_s'].items()}
  log(f'[fit-tiny] B and C equal A bit for bit ({len(dig_a)} leaf '
      f'digests, the losses, the {big} table in full); the audit found '
      'the NaN at step 4 and the rollback replayed steps 4-6')
  log('[fit-tiny] ' + json.dumps(numbers))
  return {'A': launch_a, 'B': launch_b, 'C': launch_c}, numbers


def phase_dlrm_resume():
  """Phase 13b: examples/dlrm/main.py's resume flags at the MLPerf
  widths on the onechip vocabularies.  Returns each run's launches and
  the save, restore and verify numbers."""
  sizes = [min(s, ONECHIP_MAX_ROWS) for s in data.MLPERF_SIZES]
  file_est = sum(sizes) * 128 * 4
  # run A's file stays for phase 13h beside the phase's own files
  check_disk(4.2 * file_est, 'dlrm-resume')
  root = CKPT_DIR / 'dlrm'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  common = ['--param_dtype', 'bfloat16', '--table_sizes',
            ','.join(map(str, sizes)), '--num_batches', str(FIT_STEPS),
            '--device', 'cuda']
  launches = {}

  def main(tag, steps, *argv):
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    out = dlrm_main.main(common + list(argv))
    launches[tag] = read_launches()
    want = {'lookup_combine': steps, 'segwalk_apply': steps}
    if launches[tag] != want:
      raise AssertionError(f'dlrm-resume {tag}: launched {launches[tag]}, '
                           f'expected {want}')
    log(f'[dlrm-resume] run {tag}: {time.perf_counter() - t0:.2f} s, '
        f'{json.dumps(out)}')
    return out

  def verify(path, want_rc):
    t0 = time.perf_counter()
    rc = verify_checkpoint.main([str(path), '--quiet'])
    if rc != want_rc:
      raise AssertionError(f'verify_checkpoint {path.name}: exit {rc}, '
                           f'expected {want_rc}')
    return time.perf_counter() - t0

  a, b3, b = root / 'a.npz', root / 'b3.npz', root / 'b.npz'
  out_a = main('A', FIT_STEPS, '--max_steps', str(FIT_STEPS),
               '--save_state', str(a))
  man_a = checkpoint.read_manifest(str(a))
  file_bytes = os.path.getsize(a)
  # verify_checkpoint passes b below, whose arrays are a's; 13h's export
  # verifies a itself
  SERVE_DIR.mkdir(parents=True, exist_ok=True)
  serve_ckpt = SERVE_DIR / 'ckpt_6.npz'
  os.replace(a, serve_ckpt)
  out_b3 = main('B1', 3, '--max_steps', '3', '--save_state', str(b3))
  out_b = main('B2', FIT_STEPS - 3, '--load_state', str(b3), '--max_steps',
               str(FIT_STEPS), '--save_state', str(b))
  man_b = checkpoint.read_manifest(str(b))
  if man_b['arrays'] != man_a['arrays'] or man_b['step'] != FIT_STEPS:
    bad = [k for k in man_a['arrays']
           if man_a['arrays'][k] != man_b['arrays'].get(k)]
    raise AssertionError(f'dlrm-resume: b.npz differs from a.npz in {bad}')
  verify_s = [verify(b, 0)]
  # one byte flipped in place (a copy of the 6.7 GB file cost seconds of
  # disk): b's first MiB, all that is read of it below, stays intact
  with open(b, 'r+b') as f:
    f.seek(file_bytes // 2)
    byte = f.read(1)
    f.seek(file_bytes // 2)
    f.write(bytes([byte[0] ^ 0x10]))
  verify(b, 1)
  # --resume_dir: the step-3 file and a newer, truncated one
  resume = root / 'resume'
  resume.mkdir()
  os.replace(b3, resume / 'ckpt_3.npz')
  with open(b, 'rb') as f, open(resume / 'ckpt_6.npz', 'wb') as g:
    g.write(f.read(1 << 20))
  os.remove(b)
  os.utime(resume / 'ckpt_3.npz', (1, 1))
  c = root / 'c.npz'
  out_c = main('C', FIT_STEPS - 3, '--resume_dir', str(resume),
               '--save_state', str(c))
  left = sorted(os.listdir(resume))
  if out_c['resumed_from'] != str(resume / 'ckpt_3.npz') or left != [
      'ckpt_3.npz', 'ckpt_6.npz.corrupt']:
    raise AssertionError(f'dlrm-resume C: resumed from '
                         f'{out_c["resumed_from"]}, left {left}')
  if checkpoint.read_manifest(str(c))['arrays'] != man_a['arrays']:
    raise AssertionError('dlrm-resume: c.npz differs from a.npz')
  shutil.rmtree(root)
  numbers = {
      'rows': sum(sizes), 'file_bytes': file_bytes,
      'save_s': [out_a['save_s'], out_b3['save_s'], out_b['save_s'],
                 out_c['save_s']],
      'restore_s': [out_b['restore_s'], out_c['restore_s']],
      'verify_s': verify_s, 'loss': out_a['loss'],
  }
  numbers['save_gb_per_s'] = [file_bytes / 1e9 / t
                              for t in numbers['save_s']]
  numbers['restore_gb_per_s'] = [file_bytes / 1e9 / t
                                 for t in numbers['restore_s']]
  log(f'[dlrm-resume] {len(sizes)} tables, {sum(sizes):,} rows x 128 '
      f'(onechip cut), files of {file_bytes / 1e9:.3f} GB: the resumed '
      'file equals the uninterrupted one array by array (sha256); '
      'verify_checkpoint passed b.npz and rejected it with a byte flipped; '
      '--resume_dir quarantined the truncated file and resumed at step 3')
  log('[dlrm-resume] ' + json.dumps(numbers))
  return launches, numbers, serve_ckpt


def trace_ts():
  """The tracer's clock now, as a timestamp (us) of the armed trace (its
  base is the tracer's own, ``obs.trace._t0``)."""
  return (obs_trace.now() - obs_trace._t0) * 1e6


SERVE_STAGES = ('serve/submit', 'serve/enqueue', 'serve/dispatch',
                'serve/merge', 'serve/execute', 'serve/lookup',
                'serve/demux', 'fwd/exchange', 'fwd/lookup_combine')


def serve_split(path, n_lone, windows):
  """Phase 13h's attribution from serve.py's trace: the lone requests
  (the last ``n_lone`` serve/lookup spans before the monolithic batcher
  started: the no-batching arm), the mean of their spans a request; and
  for the monolithic and the ladder+pipeline arms (``windows``: each
  batcher's start and close, trace us) the union of each stage's spans
  in the window."""
  rows = trace_report._durations(trace_report.load_trace(str(path)))
  t_mono = windows['mono'][0]
  lone = sorted((r for r in rows if r['name'] == 'serve/lookup'
                 and r['ts'] + r['dur'] <= t_mono),
                key=lambda r: r['ts'])[-n_lone:]
  lo = lone[0]['ts']
  out = {'lone': {'requests': len(lone)}}
  for name in ('serve/lookup', 'fwd/exchange', 'fwd/lookup_combine'):
    out['lone'][name] = sum(
        r['dur'] for r in rows if r['name'] == name and lo <= r['ts']
        and r['ts'] + r['dur'] <= t_mono) / 1e3 / len(lone)
  out['lone']['lookup_untraced'] = out['lone']['serve/lookup'] - (
      out['lone']['fwd/exchange'] + out['lone']['fwd/lookup_combine'])
  for arm, (a, b) in windows.items():
    inside = [r for r in rows if a <= r['ts'] and r['ts'] + r['dur'] <= b]
    enq = [r['dur'] for r in inside if r['name'] == 'serve/enqueue']
    out[arm] = {
        'wall_ms': (b - a) / 1e3,
        'union_ms': {n: trace_report.union_ms(
            [r for r in inside if r['name'] == n])
                     for n in SERVE_STAGES},
        'enqueue_ms_mean': statistics.mean(enq) / 1e3 if enq else None}
  return out


def rung_profile(tag, name, engine):
  """``devprof.profile_serving`` of ``engine``, traced: one
  dev/serve/execute event a rung, its rung in the args, the trace
  through the report, no segment walk; then rung 128's device time on
  devprof's clock over the same call."""
  obs.enable(trace_path=str(OBS_DIR / f'rungs_{name}.json'))
  reset_launches()
  walls = devprof.profile_serving(engine, reps=PROFILE_REPS)
  launched = read_launches()
  path = obs_trace.save()
  obs.reset()
  got = sorted(e['args']['rung'] for e in trace_report.load_trace(path)
               if e.get('name') == 'dev/serve/execute')
  if got != sorted(engine.buckets) or launched['segwalk_apply']:
    raise AssertionError(f'{tag}: profile_serving of {name}: rungs {got} '
                         f'for {engine.buckets}, launches {launched}')
  report_gate(tag, path, 'dev/serve/execute')
  os.remove(path)
  rng = np.random.default_rng(0)
  cats = [rng.integers(0, engine.dist.table_configs[t].input_dim,
                       size=(128,)).astype(np.int32)
          for t in engine.dist.plan.input_table_map]
  with torch.no_grad():
    dev_ms, clock = devprof.device_clock_ms(
        lambda: engine.dist.apply(engine.params, cats), PROFILE_REPS,
        engine.dist.device, walls[128])
  log(f'[{tag}] profile_serving ({name}): synced wall ms by rung '
      f'{json.dumps(walls)}; launches {json.dumps(launched)}')
  return {'rung_ms': walls, 'launches': launched,
          'rung128': {'wall_ms': walls[128], 'device_ms': dev_ms,
                      'clock': clock}}


def serve_answers(tag, subs, engine):
  """Every recorded ``(cats, future)`` of a batcher against
  ``engine.lookup_padded`` on the same request, bit for bit; returns the
  count."""
  for n, (cats, fut) in enumerate(subs):
    got = fut.result(timeout=0)
    want = serve_batcher.host_outputs(engine.lookup_padded(cats))
    for i, (g, w) in enumerate(zip(got, want)):
      if not np.array_equal(g, w):
        raise AssertionError(f'{tag}: request {n} ({len(cats[0])} samples)'
                             f' input {i} differs from lookup_padded')
  return len(subs)


def rung_batch(subs, bucket):
  """A ``bucket``-sample batch merged from recorded requests as the
  batcher merges them (hotness 1, int32)."""
  merged = [np.concatenate(c) for c in zip(*(cats for cats, _ in subs))]
  if merged[0].shape[0] < bucket:
    raise AssertionError(f'{merged[0].shape[0]} recorded samples, rung '
                         f'{bucket}')
  return [np.ascontiguousarray(c[:bucket], dtype=np.int32) for c in merged]


def phase_dlrm_serve(ckpt, card):
  """Phase 13h: examples/dlrm/serve.py in process on phase 13b's step-6
  file (the bf16 DLRM at the MLPerf widths, the onechip vocabularies).
  Returns each arm's launches, the kernel rows at each rung and the
  phase's numbers."""
  tag = 'dlrm-serve'
  ckpt = pathlib.Path(ckpt)
  size = os.path.getsize(ckpt)
  check_disk(1.05 * size, tag)
  bundle = SERVE_DIR / 'bundle.npz'
  loaded, batchers, pool_reqs = [], [], []
  orig = {'load': serving.load_serving_bundle,
          'init': serve_batcher.DynamicBatcher.__init__,
          'submit': serve_batcher.DynamicBatcher.submit,
          'close': serve_batcher.DynamicBatcher.close,
          'req': serve_pool._PoolReq.__init__}

  def load(path):
    out = orig['load'](path)
    loaded.append(out)
    return out

  def marks(engine):
    return read_launches(), engine.stats()['batches_served']

  def init(self, engine, *args, **kwargs):
    orig['init'](self, engine, *args, **kwargs)
    self.chip_marks = [marks(engine)]
    self.chip_subs = []
    self.chip_window = [trace_ts()]
    batchers.append(self)

  def submit(self, cats, *args, **kwargs):
    fut = orig['submit'](self, cats, *args, **kwargs)
    self.chip_subs.append((cats, fut))
    return fut

  def close(self):
    orig['close'](self)
    self.chip_marks.append(marks(self.engine))
    self.chip_window.append(trace_ts())

  def req_init(self, *args, **kwargs):
    orig['req'](self, *args, **kwargs)
    pool_reqs.append(self)

  serving.load_serving_bundle = load
  serve_batcher.DynamicBatcher.__init__ = init
  serve_batcher.DynamicBatcher.submit = submit
  serve_batcher.DynamicBatcher.close = close
  serve_pool._PoolReq.__init__ = req_init
  reset_launches()
  OBS_DIR.mkdir(parents=True, exist_ok=True)
  serve_trace = OBS_DIR / 'serve.json'
  t0 = time.perf_counter()
  try:
    stats = dlrm_serve.main(['--checkpoint', str(ckpt), '--bundle',
                             str(bundle), '--device', 'cuda', *SERVE_ARGV,
                             '--trace', str(serve_trace)])
  finally:
    serving.load_serving_bundle = orig['load']
    serve_batcher.DynamicBatcher.__init__ = orig['init']
    serve_batcher.DynamicBatcher.submit = orig['submit']
    serve_batcher.DynamicBatcher.close = orig['close']
    serve_pool._PoolReq.__init__ = orig['req']
  run_s = time.perf_counter() - t0
  mono, ladder, *replicas = batchers
  if (mono.pipeline or mono.bucket_ladder or not ladder.pipeline
      or not ladder.bucket_ladder or len(replicas) != 2):
    raise AssertionError(f'{tag}: {len(batchers)} batchers, not the '
                         'monolithic, the ladder and two replicas')
  engine = mono.engine
  per_lookup = hot_launches(engine.dist, engine.hotness)[0][
      'lookup_combine']
  # one batcher at a time ran on the engine until the pool: every mark's
  # launches are the engine's lookups so far times the plan's launches
  for arm, (launched, lookups) in (('nobatch', mono.chip_marks[0]),
                                   ('mono', mono.chip_marks[-1]),
                                   ('ladder', ladder.chip_marks[-1])):
    want = {'lookup_combine': lookups * per_lookup, 'segwalk_apply': 0}
    if launched != want:
      raise AssertionError(f'{tag}: after the {arm} arm {launched} for '
                           f'{lookups} lookups x {per_lookup} (the plan)')
  warm = len(engine.buckets)
  cuts = [warm, mono.chip_marks[0][1], mono.chip_marks[-1][1],
          ladder.chip_marks[-1][1]]
  lookups = {arm: b - a for arm, a, b in zip(('nobatch', 'mono', 'ladder'),
                                             cuts, cuts[1:])}
  launches = {arm: {'lookup_combine': n * per_lookup, 'segwalk_apply': 0}
              for arm, n in lookups.items()}
  end = read_launches()
  launches['overload'] = {
      name: end[name] - ladder.chip_marks[-1][0][name] for name in end}
  if launches['overload']['segwalk_apply'] or not launches['overload'][
      'lookup_combine']:
    raise AssertionError(f'{tag}: the overload arm launched '
                         f'{launches["overload"]}')
  answered = {'mono': serve_answers(f'{tag} mono', mono.chip_subs, engine),
              'ladder': serve_answers(f'{tag} ladder', ladder.chip_subs,
                                      engine)}
  report_gate(tag, serve_trace, SERVE_REQUIRE)
  split = serve_split(serve_trace, lookups['nobatch'],
                      {'mono': mono.chip_window,
                       'ladder': ladder.chip_window})
  serve_trace.unlink()
  # the overload arm: every future resolved, served or shed; the retried
  # ones (failed over from the quarantined replica 0) and the degraded
  # ones against lookup_padded on the survivor
  survivor = replicas[1].engine
  outcome = collections.Counter()
  retried = retried_served = degraded = dropped = total = 0
  for req in pool_reqs:
    if not req.future.done():
      raise AssertionError(f'{tag}: an overload future is unresolved')
    err = req.future.error()
    outcome[type(err).__name__ if err else 'served'] += 1
    retried += bool(req.retries)
    if err is not None:
      continue
    if req.degraded:
      degraded += 1
      dropped += req.dropped
      total += req.total
    if req.retries or req.degraded:
      retried_served += bool(req.retries)
      want = serve_batcher.host_outputs(survivor.lookup_padded(req.cats))
      if not all(np.array_equal(g, w)
                 for g, w in zip(req.future.result(timeout=0), want)):
        raise AssertionError(f'{tag}: a retried or degraded answer '
                             'differs from lookup_padded')
  if (sum(outcome.values()) != stats['serve_over_requests']
      or outcome['served'] != stats['serve_over_served']
      or set(outcome) - {'served', 'RequestSheddedError'}):
    raise AssertionError(f'{tag}: overload outcomes {dict(outcome)}, '
                         f'block {stats["serve_over_served"]} served')
  # the kernel at the serving shapes: one batch at each rung, every
  # launch of its lookup against the plain version
  rows = {}
  for b in engine.buckets:
    batch = rung_batch(ladder.chip_subs, b)
    rows[str(b)] = checked_sum(wire_lookup_rows(engine.dist, engine.params,
                                                batch, f'serve_b{b}'))
  # which of the ladder and the pipeline the third arm's time follows:
  # each alone over the same requests, and the third arm again with the
  # interpreter's thread switch interval at 0.5 ms (default 5 ms: a
  # thread woken by a hand-off waits for the running one to yield)
  requests = [cats for cats, _ in ladder.chip_subs]
  attribution = {}
  switch = sys.getswitchinterval()
  for arm, kw, interval in (
      ('pipeline_only', dict(bucket_ladder=False), switch),
      ('ladder_only', dict(pipeline=False), switch),
      ('ladder_pipeline_switch_0.5ms', {}, 0.0005)):
    bat = serve_batcher.DynamicBatcher(engine, max_delay_ms=2.0, **kw)
    sys.setswitchinterval(interval)
    try:
      wall = serve_bench._drive(bat, requests, 8)
      st = bat.stats()
    finally:
      sys.setswitchinterval(switch)
      bat.close()
    attribution[arm] = {
        'p50_ms': st['p50_ms'], 'p99_ms': st['p99_ms'],
        'qps': len(requests) / wall, 'batches': st['batches'],
        'batch_fill': st['batch_fill'],
        'overlap_pct': (st.get('pipeline') or {}).get('overlap_pct')}
  # serve.py's drill quarantines a replica whose batcher then drains its
  # queue, so nothing fails over there: a replica whose lookups raise
  # fails every request over to the survivor
  def failing(cats, samples=None):
    raise RuntimeError('phase 13h: injected replica fault')

  engine.lookup = failing
  drill = serving.ServingEnginePool([engine, survivor], max_delay_ms=2.0)
  try:
    futs = [(r, drill.submit(r)) for r in requests[:64]]
    for r, f in futs:
      want = serve_batcher.host_outputs(survivor.lookup_padded(r))
      if not all(np.array_equal(g, w)
                 for g, w in zip(f.result(timeout=120.0), want)):
        raise AssertionError(f'{tag}: a failed-over answer differs from '
                             'lookup_padded on the survivor')
    drill_stats = drill.stats()
  finally:
    drill.close()
    del engine.lookup
  if drill_stats['quarantined'] != 1 or drill_stats['failovers'] < 1:
    raise AssertionError(f'{tag}: failover drill {drill_stats}')
  pool_engines = {id(engine), id(survivor)}
  del batchers, mono, ladder, replicas, pool_reqs, survivor
  # the bundle: 26 tables at step 6, no optimizer member, each table's
  # sha256 the checkpoint's
  man_b = checkpoint.read_manifest(str(bundle))
  man_c = checkpoint.read_manifest(str(ckpt))
  tables = sorted(k for k in man_b['arrays'] if k.startswith('table'))
  n_tables = len(data.MLPERF_SIZES)
  if (len(tables) != n_tables or man_b['step'] != 6
      or any('/' in k or ':' in k for k in tables)
      or any(man_b['arrays'][k]['sha256'] != man_c['arrays'][k]['sha256']
             for k in tables)):
    raise AssertionError(f'{tag}: bundle tables {tables[:3]}..., step '
                         f'{man_b["step"]}: not the checkpoint\'s')
  # an engine from the bundle alone, no model code: sampled answers
  # against a plain gather of the bundle's arrays
  weights, meta = loaded[0]
  t1 = time.perf_counter()
  bare = ServingEngine.from_bundle(str(bundle), batch_size=1024,
                                   device='cuda')
  from_bundle_s = time.perf_counter() - t1
  rng = np.random.default_rng(13)
  sample = [rng.integers(0, c.input_dim, size=(SERVE_CHECK_SAMPLES,))
            .astype(np.int32) for c in meta['table_configs']]
  reset_launches()
  got = bare.lookup_padded(sample)
  torch.cuda.synchronize()
  bare_launches = read_launches()
  want_launches = {'lookup_combine': chunk_rounds(bare.dist, bare.hotness),
                   'segwalk_apply': 0}
  if bare_launches != want_launches:
    raise AssertionError(f'{tag}: the bundle engine launched '
                         f'{bare_launches}, expected {want_launches}')
  for i, (g, w, ids) in enumerate(zip(got, weights, sample)):
    if not np.array_equal(g.cpu().numpy(), w[ids]):
      raise AssertionError(f'{tag}: from_bundle input {i} differs from a '
                           'plain gather of the bundle')
  # the execute phase at each rung (devprof.profile_serving): the bundle's
  # engine, and serve.py's with its hot sets, whose path the lone
  # requests took
  rungs = {}
  for name, eng in (('from_bundle', bare), ('serve_hot', engine)):
    rungs[name] = rung_profile(tag, name, eng)
  del bare, got, weights, loaded
  gc.collect()
  torch.cuda.empty_cache()
  # one flipped byte: the bundle refuses to load
  with open(bundle, 'r+b') as f:
    f.seek(os.path.getsize(bundle) // 2)
    byte = f.read(1)
    f.seek(-1, os.SEEK_CUR)
    f.write(bytes([byte[0] ^ 0x10]))
  t1 = time.perf_counter()
  try:
    serving.load_serving_bundle(str(bundle))
  except ValueError as e:
    if 'invalid serving bundle' not in str(e):
      raise
  else:
    raise AssertionError(f'{tag}: the flipped bundle loaded')
  refuse_s = time.perf_counter() - t1
  bundle.unlink()  # the step-6 file stays for phase 13i
  shutil.rmtree(OBS_DIR, ignore_errors=True)
  numbers = {
      'run_s': run_s, 'from_bundle_s': from_bundle_s, 'refuse_s': refuse_s,
      'bundle_bytes': size, 'lookups': lookups, 'per_lookup': per_lookup,
      'answers': answered, 'overload': dict(outcome),
      'retried': retried, 'retried_served': retried_served,
      'degraded': degraded,
      'hot_only_dropped': dropped, 'hot_only_total': total,
      'replica_engines': len(pool_engines),
      'attribution': attribution, 'split': split, 'rungs': rungs,
      'failover_drill': {k: drill_stats[k] for k in (
          'failovers', 'quarantined', 'completed', 'p50_ms', 'p99_ms')},
      'stats': stats,
  }
  rows_total = sum(man_c['arrays'][k]['shape'][0] for k in tables)
  log(f'[{tag}] card {card}; {n_tables} tables, {rows_total:,} rows x 128 '
      f'(onechip cut): the bundle lists the checkpoint\'s sha256 for every '
      f'table and no optimizer member; serve.py in {run_s:.1f} s')
  log(f'[{tag}] launches by arm {json.dumps(launches)} ({per_lookup} a '
      'lookup from the plan: the cold gather and the hot partial)')
  log(f'[{tag}] answers bit-equal to lookup_padded: monolithic '
      f'{answered["mono"]}, ladder+pipeline {answered["ladder"]}; '
      f'overload outcomes {dict(outcome)}; of {retried} requests retried '
      f'after the quarantine {retried_served} served (the rest shed), '
      f'and they and {degraded} degraded answers '
      'bit-equal on the survivor; hot_only_filter dropped '
      f'{dropped} of {total} ids')
  log(f'[{tag}] shed ledger: high {stats["serve_over_high_shed"]}, low '
      f'{stats["serve_over_low_shed"]}; by reason deadline '
      f'{stats["serve_over_shed_deadline"]}, queue_full '
      f'{stats["serve_over_shed_queue_full"]}; degraded enters '
      f'{stats["serve_over_degraded_enters"]}, exits '
      f'{stats["serve_over_degraded_exits"]}')
  log(f'[{tag}] each alone over the same requests: '
      f'{json.dumps(attribution)}; failover drill (replica 0 raising): 64 '
      f'answers bit-equal to lookup_padded on the survivor, '
      f'{drill_stats["failovers"]} failovers')
  log(f'[{tag}] from_bundle (no model code) in {from_bundle_s:.2f} s: '
      f'{SERVE_CHECK_SAMPLES} sampled answers equal a plain gather of the '
      f'bundle, launches {json.dumps(bare_launches)}; the bundle with one '
      f'byte flipped refused in {refuse_s:.2f} s')
  lone = split['lone']
  log(f'[{tag}] card {card}; a lone request (no batching, rung 128, '
      f'{lone["requests"]} requests): p50 {stats["serve_nobatch_p50_ms"]} '
      f'ms, of it a mean {lone["serve/lookup"]:.4f} ms in serve/lookup '
      f'(fwd/exchange {lone["fwd/exchange"]:.4f}, fwd/lookup_combine '
      f'{lone["fwd/lookup_combine"]:.4f}, the rest of the lookup '
      f'{lone["lookup_untraced"]:.4f}); rung 128 dist.apply on random ids: '
      f'{rungs["serve_hot"]["rung128"]["wall_ms"]:.4f} ms synced wall, '
      f'{rungs["serve_hot"]["rung128"]["device_ms"]:.4f} ms device clock '
      f'({rungs["serve_hot"]["rung128"]["clock"]}) with the hot sets; '
      f'{rungs["from_bundle"]["rung128"]["wall_ms"]:.4f} / '
      f'{rungs["from_bundle"]["rung128"]["device_ms"]:.4f} ms '
      f'({rungs["from_bundle"]["rung128"]["clock"]}) without; the rung\'s '
      f'kernels {rows["128"]["kernel_ms"]:.4f} ms (queued CUDA events)')
  for arm in ('mono', 'ladder'):
    a = split[arm]
    log(f'[{tag}] {arm} arm, {a["wall_ms"]:.1f} ms wall: union ms (share '
        'of the wall) ' + ', '.join(
            f'{n} {v:.1f} ({100 * v / a["wall_ms"]:.1f} %)'
            for n, v in a['union_ms'].items())
        + f'; serve/enqueue a request {a["enqueue_ms_mean"]:.3f} ms mean')
  log(f'[{tag}] ' + json.dumps(numbers))
  return launches, rows, numbers


def serve_rank(rank, init, out_dir, ckpt):
  """One of phase 13i's two ranks (a process of its own, both on the one
  card, joined over gloo): examples/dlrm/serve.py's ``main`` with the
  world's flags, recording every engine, the lookup launches of one
  batch at each of ``SERVE_RANKS_CHECK_RUNGS`` and, on the leader, the
  bundle, the batchers' requests and the pool's.  Then the checks (see
  the module docstring) and the kernel shapes, timed after the ranks
  before this one (``timed{r}`` markers).  Writes ``rank{rank}.json``
  under ``out_dir``."""
  out_dir = pathlib.Path(out_dir)
  engines, fronts, loaded, batchers, pool_reqs = [], [], [], [], []
  captures = {}
  capturing = [None]
  orig = {'engine': ServingEngine.__init__,
          'front': serving.RankFrontEnd.__init__,
          'block': ServingEngine.apply_block,
          'load': serving.load_serving_bundle,
          'init': serve_batcher.DynamicBatcher.__init__,
          'submit': serve_batcher.DynamicBatcher.submit,
          'close': serve_batcher.DynamicBatcher.close,
          'req': serve_pool._PoolReq.__init__,
          'fused': lookup.fused_group_lookup, 'dense': lookup.dense_lookup}

  def engine_init(self, *args, **kwargs):
    orig['engine'](self, *args, **kwargs)
    engines.append(self)

  def front_init(self, *args, **kwargs):
    orig['front'](self, *args, **kwargs)
    fronts.append(self)

  def apply_block(self, padded, b):
    # the first batch at a checked rung: its launches are recorded
    if b in SERVE_RANKS_CHECK_RUNGS and b not in captures:
      capturing[0] = captures[b] = []
    try:
      return orig['block'](self, padded, b)
    finally:
      capturing[0] = None

  def record_fused(table, routed, combiners, compute_dtype, scale=None):
    if capturing[0] is not None:
      capturing[0].extend((table, r.reshape(-1, r.shape[-1]).clone(), c,
                           scale) for r, c in zip(routed, combiners))
    return orig['fused'](table, routed, combiners, compute_dtype, scale)

  def record_dense(table, ids, combiner, out_dtype=None, scale=None):
    if capturing[0] is not None:
      capturing[0].append((table, ids.clone(), combiner, scale))
    return orig['dense'](table, ids, combiner, out_dtype, scale)

  def load(path):
    got = orig['load'](path)
    loaded.append(got)
    return got

  def init_batcher(self, engine, *args, **kwargs):
    orig['init'](self, engine, *args, **kwargs)
    self.chip_subs = []
    self.chip_window = [trace_ts()]
    batchers.append(self)

  def submit(self, cats, *args, **kwargs):
    fut = orig['submit'](self, cats, *args, **kwargs)
    self.chip_subs.append((cats, fut))
    return fut

  def close_batcher(self):
    orig['close'](self)
    self.chip_window.append(trace_ts())

  def req_init(self, *args, **kwargs):
    orig['req'](self, *args, **kwargs)
    pool_reqs.append(self)

  ServingEngine.__init__ = engine_init
  serving.RankFrontEnd.__init__ = front_init
  ServingEngine.apply_block = apply_block
  serving.load_serving_bundle = load
  serve_batcher.DynamicBatcher.__init__ = init_batcher
  serve_batcher.DynamicBatcher.submit = submit
  serve_batcher.DynamicBatcher.close = close_batcher
  serve_pool._PoolReq.__init__ = req_init
  lookup.fused_group_lookup = record_fused
  lookup.dense_lookup = record_dense
  reset_launches()
  trace = out_dir / 'serve_trace.json'  # written by the leader alone
  t0 = time.perf_counter()
  try:
    returned = dlrm_serve.main(
        ['--checkpoint', str(ckpt), '--bundle', str(SERVE_DIR / 'ranks.npz'),
         '--device', 'cuda', *SERVE_RANKS_ARGV, '--init_method', init,
         '--world_size', str(SERVE_RANKS_WORLD), '--rank', str(rank),
         '--dist_backend', 'gloo', '--trace', str(trace)])
    torch.cuda.synchronize()
  finally:
    for name, cls_attr in (('engine', (ServingEngine, '__init__')),
                           ('front', (serving.RankFrontEnd, '__init__')),
                           ('block', (ServingEngine, 'apply_block')),
                           ('init', (serve_batcher.DynamicBatcher,
                                     '__init__')),
                           ('submit', (serve_batcher.DynamicBatcher,
                                       'submit')),
                           ('close', (serve_batcher.DynamicBatcher,
                                      'close')),
                           ('req', (serve_pool._PoolReq, '__init__'))):
      setattr(*cls_attr, orig[name])
    serving.load_serving_bundle = orig['load']
    lookup.fused_group_lookup = orig['fused']
    lookup.dense_lookup = orig['dense']
  run_s = time.perf_counter() - t0
  tag = f'dlrm-serve-ranks rank {rank}'
  launched = read_launches()
  engine = engines[0]
  per_lookup = hot_launches(engine.dist, engine.hotness)[0]['lookup_combine']
  lookups = [e.stats()['batches_served'] for e in engines]
  want = {'lookup_combine': sum(lookups) * per_lookup, 'segwalk_apply': 0}
  if len(engines) != 2 or launched != want:
    raise AssertionError(f'{tag}: {launched} launched by {len(engines)} '
                         f'engines\' {lookups} lookups x {per_lookup} (the '
                         'plan)')
  result = {'rank': rank, 'run_s': run_s, 'launches': launched,
            'lookups': lookups, 'per_lookup': per_lookup}
  if rank == 0:
    weights, _ = loaded[0]

    def gathered(cats):
      return [np.where((c >= 0)[:, None], w[np.maximum(c, 0)], 0)
              for c, w in zip(cats, weights)]

    def equal(answer, cats):
      return all(np.array_equal(a, g)
                 for a, g in zip(answer, gathered(cats)))

    mono, ladder, *replicas = batchers
    if (mono.pipeline or mono.bucket_ladder or not ladder.pipeline
        or not ladder.bucket_ladder or len(replicas) != 2):
      raise AssertionError(f'{tag}: {len(batchers)} batchers, not the '
                           'monolithic, the ladder and two replicas')
    answered = {}
    for arm, bat in (('mono', mono), ('ladder', ladder)):
      for n, (cats, fut) in enumerate(bat.chip_subs):
        if not equal(fut.result(timeout=0), [np.asarray(c) for c in cats]):
          raise AssertionError(f'{tag}: {arm} request {n} differs from a '
                               'gather of the bundle')
      answered[arm] = len(bat.chip_subs)
    outcome = collections.Counter()
    retried = degraded = 0
    for req in pool_reqs:
      if not req.future.done():
        raise AssertionError(f'{tag}: an overload future is unresolved')
      err = req.future.error()
      outcome[type(err).__name__ if err else 'served'] += 1
      if err is not None:
        continue
      retried += bool(req.retries)
      degraded += req.degraded
      if not equal(req.future.result(timeout=0),
                   [np.asarray(c) for c in req.cats]):
        raise AssertionError(f'{tag}: an overload answer differs from a '
                             'gather of the bundle')
    if (sum(outcome.values()) != returned['serve_over_requests']
        or outcome['served'] != returned['serve_over_served']
        or set(outcome) - {'served', 'RequestSheddedError'}):
      raise AssertionError(f'{tag}: overload outcomes {dict(outcome)}')
    # the leader's trace: the request path's spans, the broadcast and the
    # gather inside serve/lookup; a lone request's split and each
    # batcher's stage unions, as phase 13h reads its own
    report_gate(tag, trace, SERVE_REQUIRE)
    split = serve_split(trace, returned['serve_requests'],
                        {'mono': mono.chip_window,
                         'ladder': ladder.chip_window})
    trace.unlink()
    result.update(stats=returned, answers=answered, overload=dict(outcome),
                  retried_served=retried, degraded=degraded,
                  front_end=fronts[0].stats()['front_end'], split=split)
    del weights, loaded
  else:
    result['counts'] = returned
  # the kernel at this rank's block shapes, after the ranks before it
  if rank:
    wait_for = out_dir / f'timed{rank - 1}'
    deadline = time.monotonic() + SERVE_RANKS_TIMEOUT_S
    while not wait_for.exists():
      if time.monotonic() > deadline:
        raise AssertionError(f'{tag}: rank {rank - 1} never timed')
      time.sleep(0.2)
  rows = {}
  for b in SERVE_RANKS_CHECK_RUNGS:
    if any(c not in (None, 'sum') for _, _, c, _ in captures[b]):
      raise AssertionError(f'{tag}: the DLRM combines with sum only')
    launches = [check_kernel_shape(table, ids, f'serve_ranks_r{rank}_b{b}_'
                                   f'w{table.shape[1]}_n{ids.shape[0]}_'
                                   f'rows{table.shape[0]}')
                for table, ids, _, scale in captures[b] if scale is None]
    rows[str(b)] = {**checked_sum(launches),
                    'shapes': [r['shape'] for r in launches],
                    'kernel_ms_each': [r['kernel_ms'] for r in launches]}
    if rows[str(b)]['launches'] != len(captures[b]) or not len(captures[b]):
      raise AssertionError(f'{tag}: rung {b} captured {captures[b]!r}')
  result['rows'] = rows
  with open(out_dir / f'rank{rank}.json', 'w') as f:
    json.dump(result, f)
  (out_dir / f'timed{rank}').write_text('timed\n')


def phase_dlrm_serve_ranks(ckpt, card):
  """Phase 13i: two processes on the one card, joined over gloo, run
  ``serve_rank`` (see the module docstring) through ``launch_ranks`` on
  phase 13b's step-6 file, which 13h kept; then the ranks' counts
  against each other, the leader's block printed, the files deleted.
  Returns each rank's launches, kernel rows and the phase's numbers."""
  tag = 'dlrm-serve-ranks'
  check_disk(1.05 * os.path.getsize(ckpt), tag)
  root = CKPT_DIR.parent / 'chip_smoke_serve_ranks'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  wall = launch_ranks(tag, root, 'serve_rank', SERVE_RANKS_WORLD,
                      SERVE_RANKS_TIMEOUT_S, str(ckpt))
  ranks = []
  for rank in range(SERVE_RANKS_WORLD):
    with open(root / f'rank{rank}.json') as f:
      ranks.append(json.load(f))
  shutil.rmtree(root)
  shutil.rmtree(SERVE_DIR)
  lead, follower = ranks
  if not (follower['counts']['by_replica'] == lead['lookups']
          == follower['lookups']):
    raise AssertionError(f'{tag}: the follower ran '
                         f'{follower["counts"]["by_replica"]} batches by '
                         f'replica, the leader sent {lead["lookups"]}')
  stats = lead['stats']
  log(f'[{tag}] card {card}; two ranks on the one card over gloo (host '
      f'staging: not NCCL serving speeds), serve.py in {lead["run_s"]:.1f}'
      f' / {follower["run_s"]:.1f} s, both ranks done in {wall:.1f} s')
  log(f'[{tag}] launches by rank {json.dumps([r["launches"] for r in ranks])}'
      f' for {json.dumps([r["lookups"] for r in ranks])} lookups by replica '
      f'x {lead["per_lookup"]} (the plan: the cold gather and the hot '
      'partial on each rank\'s block)')
  log(f'[{tag}] answers equal to a gather of the bundle: monolithic '
      f'{lead["answers"]["mono"]}, ladder+pipeline '
      f'{lead["answers"]["ladder"]}; overload outcomes '
      f'{lead["overload"]}, every served answer equal ({lead["degraded"]} '
      f'degraded, {lead["retried_served"]} retried)')
  log(f'[{tag}] card {card}; A/B no-batch p50 '
      f'{stats["serve_nobatch_p50_ms"]} ms p99 {stats["serve_nobatch_p99_ms"]}'
      f' qps {stats["serve_nobatch_qps"]} | monolithic p50 '
      f'{stats["serve_mono_p50_ms"]} p99 {stats["serve_mono_p99_ms"]} qps '
      f'{stats["serve_mono_qps"]} | ladder+pipe p50 {stats["serve_p50_ms"]} '
      f'p99 {stats["serve_p99_ms"]} qps {stats["serve_qps"]} | overload '
      f'served {stats["serve_over_served"]} shed {stats["serve_over_shed"]}'
      f' high p99 {stats["serve_over_high_p99_ms"]} ms')
  fe = lead['front_end']
  log(f'[{tag}] the leader\'s front end: {fe["batches"]} batches (every '
      f'replica\'s), broadcast {fe["broadcast_ms"]:.1f} ms in all '
      f'({fe["broadcast_ms"] / fe["batches"]:.3f} a batch), gather '
      f'{fe["gather_ms"]:.1f} ms ({fe["gather_ms"] / fe["batches"]:.3f} a '
      'batch, the follower\'s lag included), host clock')
  lone, split = lead['split']['lone'], lead['split']
  log(f'[{tag}] card {card}; a lone request (no batching, rung 128, '
      f'{lone["requests"]} requests): p50 {stats["serve_nobatch_p50_ms"]} '
      f'ms, of it a mean {lone["serve/lookup"]:.4f} ms in the leader\'s '
      f'serve/lookup (broadcast, its block, gather; of it fwd/exchange '
      f'{lone["fwd/exchange"]:.4f}, fwd/lookup_combine '
      f'{lone["fwd/lookup_combine"]:.4f}, the rest '
      f'{lone["lookup_untraced"]:.4f})')
  for arm in ('mono', 'ladder'):
    a = split[arm]
    log(f'[{tag}] {arm} arm, {a["wall_ms"]:.1f} ms wall: union ms (share '
        'of the wall) ' + ', '.join(
            f'{n} {v:.1f} ({100 * v / a["wall_ms"]:.1f} %)'
            for n, v in a['union_ms'].items()))
  log(f'[{tag}] each rank\'s block launches held against the plain '
      'version (queued CUDA events, the ranks in turn): ' + json.dumps(
          clocked({r['rank']: r['rows'] for r in ranks})))
  numbers = {'wall_s': wall, 'ranks': ranks}
  log(f'[{tag}] ' + json.dumps(numbers))
  return ({r['rank']: r['launches'] for r in ranks},
          {r['rank']: r['rows'] for r in ranks}, numbers)


def run_small(seed, lookup_k, seg_k):
  """Synthetic Small V3 at full size in bf16 (tables and compute),
  ``dp_input=True``, tables drawn on the card: 3 forwards checked
  against a plain reference, the lookup kernel on their ids; then the
  JAX bench's jumbo-scale optimizer configuration
  (``SparseAdagrad(0.01, stream_dtype='bfloat16', accum_dtype=
  'bfloat16')`` on the segment walk, ``optim.adagrad(0.01, 0.1, 1e-7)``
  on the bf16 MLP): one warm-up step, 5 timed steps through the bf16
  arms, a profile and the host syncs; then one more step's streams, the
  kernel against its plain version on compact copies (adagrad_dedup on
  both bf16 arms, sgd on the bf16 stream) with the times of each arm,
  of the f32 arms on the same stream and of ``index_add_``.  Returns the
  summary entries of the two arms, and adds a ``small`` entry to the
  lookup's and the segment walk's (``lookup_k``, ``seg_k``)."""
  config = SYNTHETIC_MODELS['small']
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = SyntheticModel(config, dp_input=True, param_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16,
                         device='cuda').init(seed)
  torch.cuda.synchronize()
  dist = model.dist_embedding
  tables, _, _ = expand_tables(config)
  log(f'[small] {config.name}: {len(tables)} tables, {dist.num_inputs} '
      f'inputs, {sum(t.input_dim for t in tables):,} rows, bf16: '
      f'{model.total_table_gib():.3f} GiB, drawn on the card in '
      f'{time.perf_counter() - t0:.2f} s (peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB); groups '
      f'{[(g.width, g.rows_cap) for g in dist.plan.groups]} (width, '
      f'rows); MLP {model.mlp.dims}')
  t0 = time.perf_counter()
  batches = train_batches(config, model.hotness, seed + 6,
                          TRAIN_STEPS + 5)
  log(f'[small] {len(batches)} batches of {BATCH} drawn on the host in '
      f'{time.perf_counter() - t0:.2f} s (alpha 1.05)')
  cats, (numerical, _) = batches[0]
  lk_rows, _ = phase_kernels(model, numerical, cats, bf16_copy=False)
  _, fwd_launches = phase_forward(model, numerical, cats, tag='small')
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  emb_opt = sparse.SparseAdagrad(LR, stream_dtype='bfloat16',
                                 accum_dtype='bfloat16',
                                 use_segwalk_apply=True)
  step, state = build_trainer(model, emb_opt)
  torch.cuda.synchronize()
  log(f'[small-train] state: tables and bf16 accumulators, device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB')
  per_step = {'lookup_combine': n_subs, 'segwalk_apply': n_groups,
              'segwalk_apply:bf16_accumulator': n_groups,
              'segwalk_apply:bf16_stream': n_groups}
  state, launches, times, peak = timed_steps(
      'small-train', step, state, batches[1:],
      {k: v * TRAIN_STEPS for k, v in per_step.items()})
  phase_train_profile(step, state, batches[TRAIN_STEPS + 2],
                      tag='small-profile')
  state, loss, calls = captured_compact_applies(step, state,
                                                *batches[TRAIN_STEPS + 3])
  if not bool(torch.isfinite(loss)) or len(calls) != n_groups:
    raise AssertionError(f'small capture step: loss {float(loss)}, '
                         f'{len(calls)} applies')
  rows = phase_small_segwalk(calls)
  path = [r for r in rows if r['op'] == 'adagrad_dedup']
  sgd = [r for r in rows if r['op'] == 'sgd']
  lookup_k['small'] = {
      'launches': launches['lookup_combine'],
      'launches_forward': fwd_launches['lookup_combine'],
      'shapes': [{key: r[key] for key in ('shape', 'M', 'h', 'w', 'dtype',
                                          'distinct_rows', 'kernel_ms',
                                          'bound_ms', 'max_abs_err')}
                 for r in lk_rows],
      'table_rows': sum(t.input_dim for t in tables),
      **{key: sum(r[key] for r in lk_rows)
         for key in ('plain_ms', 'bound_ms', 'library_ms')},
      'ms': sum(r['kernel_ms'] for r in lk_rows),
      'max_abs_err': max(r['max_abs_err'] for r in lk_rows),
  }
  seg_k['small'] = {'launches': launches['segwalk_apply'],
                    'step_ms': times, 'peak_gib': peak / 2**30}
  stream_arm = summed(ARMS[0], launches['segwalk_apply:bf16_stream'], sgd, {
      'f32_stream_ms': sum(r['f32_stream_ms'] for r in sgd),
      'note': 'ms, plain_ms, bound_ms, library_ms: sgd on the bf16 stream; '
              'the path runs this arm inside its adagrad_dedup applies '
              '(the bf16_accumulator entry times them)'})
  acc_arm = summed(ARMS[1], launches['segwalk_apply:bf16_accumulator'],
                   path, {
                       'f32_arms_ms': sum(r['f32_arms_ms'] for r in path),
                       'f32_arms_bound_ms': sum(r['f32_arms_bound_ms']
                                                for r in path),
                       'step_ms': times, 'peak_gib': peak / 2**30})
  return stream_arm, acc_arm


def phase_small_segwalk(calls):
  """Each captured stream of Small V3: adagrad_dedup on both bf16 arms
  (the path's op) and sgd on the bf16 stream, kernel against plain on
  compact copies, the former also against what the step wrote; sampled
  untouched rows unchanged.  Timed on the real tables at lr 0 (which
  leaves the tables as they are; the timed Adagrad applies add to the
  accumulators, which nothing reads after this phase): each arm and, in
  turns with it, the f32 stream and f32 accumulator on the same stream
  (their accumulator a converted copy); ``index_add_`` of the bf16
  rows."""
  rows = []
  for call in calls:
    table, acc, grads = call['table'], call['acc'], call['grads']
    label = f'small_w{table.shape[1]}_rows{table.shape[0]}'
    if (call['op'], grads.dtype, acc.dtype) != (
        'adagrad_dedup', torch.bfloat16, torch.bfloat16):
      raise AssertionError(f'{label}: the path applies adagrad_dedup on a '
                           f'bf16 stream and accumulator, captured '
                           f'{call["op"]} {grads.dtype} {acc.dtype}')
    check_untouched(call, label)
    touched = call['touched'].long()
    err, tol = check_compact(call, 'adagrad_dedup', grads, label,
                             stepped=(table[touched], acc[touched]))
    sgd_err, sgd_tol = check_compact(call, 'sgd', grads, label)
    segs = segwalk.sort_stream(call['ids'], table.shape[0], call['g_index'])
    apply = lambda a, g, op: lambda: segwalk.apply_segments(
        table, a, segs, g, 0.0, op=op, eps=call['eps'])
    kept = table[touched]
    acc32, grads32 = acc.float(), grads.float()
    runs = {('adagrad_dedup', 'bf16'): apply(acc, grads, 'adagrad_dedup'),
            ('adagrad_dedup', 'f32'): apply(acc32, grads32, 'adagrad_dedup'),
            ('sgd', 'bf16'): apply(None, grads, 'sgd'),
            ('sgd', 'f32'): apply(None, grads32, 'sgd')}
    floors = {
        (op, arms): segwalk_bound(segs, g, table, a, op)[1]
        for op, arms, g, a in (
            ('adagrad_dedup', 'bf16', grads, acc),
            ('adagrad_dedup', 'f32', grads32, acc32),
            ('sgd', 'bf16', grads, None), ('sgd', 'f32', grads32, None))}
    # the bf16 arms and the f32 arms on the same stream in turns (bf16,
    # f32, f32, bf16), so that neither gains from its place in the order
    turns = collections.defaultdict(list)
    for arms in ('bf16', 'f32', 'f32', 'bf16'):
      for op in ('adagrad_dedup', 'sgd'):
        turns[op, arms].append(device_ms(runs[op, arms], 10,
                                         floor_ms=floors[op, arms]))
    mean = lambda op, arms: mean_ms(turns[op, arms])
    plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
        table, acc, segs, grads, 0.0, op='adagrad_dedup', eps=call['eps']))
    sgd_plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
        table, None, segs, grads, 0.0, op='sgd'))
    lo, hi = int(segs.starts[0]), int(segs.ends[-1])
    lib_ids = segs.sorted_ids[lo:hi].long()
    lib_g = grads[segs.gidx[lo:hi].long()]
    library_ms = device_ms(lambda: table.index_add_(0, lib_ids, lib_g,
                                                    alpha=-0.0), 10,
                           floor_ms=floors['sgd', 'bf16'])
    del lib_ids, lib_g, runs
    f32_bytes, f32_bound_ms, _ = segwalk_bound(segs, grads32, table, acc32,
                                               'adagrad_dedup')
    del acc32, grads32
    if not torch.equal(table[touched], kept):
      raise AssertionError(f'{label}: an apply at lr 0 changed the table')
    row, _ = stream_row(
        call, 'adagrad_dedup', grads, acc, label, err, tol,
        mean('adagrad_dedup', 'bf16'), plain_ms, None,
        f32_arms_ms=mean('adagrad_dedup', 'f32'), f32_arms_bytes=f32_bytes,
        f32_arms_bound_ms=f32_bound_ms,
        turns_ms={a: turns['adagrad_dedup', a] for a in ('bf16', 'f32')})
    sgd_row, _ = stream_row(
        call, 'sgd', grads, None, label, sgd_err, sgd_tol, mean('sgd', 'bf16'),
        sgd_plain_ms, library_ms, f32_stream_ms=mean('sgd', 'f32'),
        turns_ms={a: turns['sgd', a] for a in ('bf16', 'f32')})
    for r in (row, sgd_row):
      log('[small-segwalk] ' + json.dumps(clocked(r)))
    rows += [row, sgd_row]
    torch.cuda.empty_cache()
  return rows


def as_ragged(c, hot_cap=None):
  """A ``[B, h]`` -1-padded input (a prefix of ids a row) as the
  ``RaggedBatch`` of the same rows on the card."""
  c = np.asarray(c)
  valid = c >= 0
  r = RaggedBatch.from_row_lengths(c[valid], valid.sum(axis=1))
  r.hot_cap = hot_cap
  return r.to('cuda')


def ragged_cats(cats, hot_cap=None):
  """The multi-hot inputs of a batch as ``RaggedBatch``es on the card,
  the hotness-1 ones as they are."""
  return [as_ragged(c, hot_cap) if np.ndim(c) == 2 else c for c in cats]


def phase_ragged_tiny(model, config, seed):
  """Phase 9d: the tiny model's multi-hot inputs as ``RaggedBatch``es
  (rows of 1-10 ids), one forward against the same ids as the dense
  layout (bit-exact), then a warm-up and ``RAGGED_STEPS`` hybrid steps
  on each layout from the same tables (drawn anew from the seed); the
  ragged run's tables against the dense run's; the host syncs of one
  more step with and without ``hot_cap``."""
  dist = model.dist_embedding
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  want = {'lookup_combine': RAGGED_STEPS * n_subs,
          'segwalk_apply': RAGGED_STEPS * n_groups}
  dense = train_batches(config, model.hotness, seed + 13, RAGGED_STEPS + 2)
  spare = dense.pop()
  ragged = [(ragged_cats(cats), batch) for cats, batch in dense]
  multi = [i for i, h in enumerate(model.hotness) if h > 1]
  caps = {dist._ragged_cap(ragged[0][0][i]) for i in multi}
  lengths = [int(ragged[0][0][i].row_lengths().min()) for i in multi] + [
      int(ragged[0][0][i].row_lengths().max()) for i in multi]

  model.embedding_params = {}
  gc.collect()
  torch.cuda.empty_cache()
  model.init(seed + 13)
  reset_launches()
  with torch.no_grad():
    got = dist.apply(model.embedding_params, ragged[0][0])
    fwd_launches = read_launches()
    want_outs = dist.apply(model.embedding_params, dense[0][0])
  if fwd_launches != {'lookup_combine': n_subs, 'segwalk_apply': 0}:
    raise AssertionError(f'ragged-tiny forward: launched {fwd_launches}, '
                         f'{n_subs} lookups expected')
  for i, (g, w) in enumerate(zip(got, want_outs)):
    if not torch.equal(g, w):
      raise AssertionError(f'ragged-tiny input {i}: the ragged forward '
                           'differs from the hand-densified one (bit-exact '
                           f'expected), max err {float((g - w).abs().max())}')
  del got, want_outs
  log(f'[ragged-tiny] {len(multi)} inputs as RaggedBatch (row lengths '
      f'{min(lengths)}-{max(lengths)}), densified at _ragged_cap '
      f'{sorted(caps)} (the dense layout: hotness 10); the forward equals '
      f'the hand-densified one bit for bit; launches '
      f'{json.dumps(fwd_launches)}')

  runs = {}
  for tag, batches in (('ragged', ragged), ('dense', dense)):
    model.embedding_params = {}
    gc.collect()
    torch.cuda.empty_cache()
    model.init(seed + 13)
    step, state = build_trainer(model)
    lookup.ARM_LAUNCHES.clear()
    state, launches, times, _ = timed_steps(f'ragged-tiny-{tag}', step,
                                            state, batches, want,
                                            n_steps=RAGGED_STEPS)
    if lookup.ARM_LAUNCHES['csr']:
      raise AssertionError('ragged-tiny: the densified inputs reached the '
                           'CSR arm')
    runs[tag] = {'launches': launches, 'times': times}
    if tag == 'ragged':
      tables = {k: v.clone() for k, v in state.params['embedding'].items()}
      # the ragged batches on the card before the step, as a loader
      # would hand them over
      spare_r, spare_cap = ragged_cats(spare[0]), ragged_cats(spare[0], 10)
      syncs = host_syncs(lambda: step(state, spare_r, spare[1]))
      syncs_cap = host_syncs(lambda: step(state, spare_cap, spare[1]))
      del step, state
      continue
    exact, err = True, 0.0
    for k, t in state.params['embedding'].items():
      same, e = compare_tables(t, tables[k])
      exact, err = exact and same, max(err, e)
      for r0 in range(0, t.shape[0], CHECK_BLOCK_ROWS):
        if not torch.allclose(tables[k][r0:r0 + CHECK_BLOCK_ROWS],
                              t[r0:r0 + CHECK_BLOCK_ROWS], rtol=1e-6,
                              atol=1e-6):
          raise AssertionError(f'ragged-tiny {k}: tables after the ragged '
                               f'steps differ from the dense ones, max err '
                               f'{e} (rtol = atol = 1e-6)')
    del tables
    syncs_dense = host_syncs(lambda: step(state, *spare))
    del step, state
  syncs_numbers = {'ragged': sum(syncs.values()),
                   'ragged_hot_cap': sum(syncs_cap.values()),
                   'dense': sum(syncs_dense.values())}
  log(f'[ragged-tiny] tables after {RAGGED_STEPS} steps on ragged inputs '
      f'against the same steps on the dense layout: '
      f'{"bit-exact" if exact else "within rtol = atol = 1e-6"} (max abs '
      f'err {err})')
  log(f'[ragged-tiny] host syncs of one step: ragged {syncs_numbers["ragged"]}'
      f', ragged with hot_cap {syncs_numbers["ragged_hot_cap"]}, dense '
      f'{syncs_numbers["dense"]}; by line: ragged '
      f'{json.dumps(dict(syncs.most_common()))}; hot_cap '
      f'{json.dumps(dict(syncs_cap.most_common()))}')
  gc.collect()
  torch.cuda.empty_cache()
  return {'launches': runs['ragged']['launches'],
          'forward_launches': fwd_launches,
          'step_ms': runs['ragged']['times'],
          'dense_step_ms': runs['dense']['times'],
          'tables_bit_exact': exact, 'max_abs_err': err,
          'host_syncs': syncs_numbers}


def hot_launches(dist, hotness):
  """Kernel launches of one cached forward and of one cached hybrid step
  of a hot-cache layer: lookups, one cold-row gather per subgroup and
  one hot partial per (hot group, hotness) class; segment walks, one
  'add' per subgroup (the cold grads) and per read hot group (the hot
  grads), and one apply per group.  ``(forward, step)`` dicts."""
  subs = dist._subgroups(tuple(hotness))
  readers = dist._hot_meta()['readers']
  classes = {(gi, hotness[r[0]]) for gi, rs in readers.items() for r in rs}
  fwd = chunk_rounds(dist, hotness) + len(classes)
  adds = len(subs) + sum(1 for rs in readers.values() if rs)
  applies = len({s.gi for s in subs})
  return ({'lookup_combine': fwd, 'segwalk_apply': 0},
          {'lookup_combine': fwd, 'segwalk_apply': adds + applies})


def chunk_rounds(dist, hotness):
  """The dp (or cold) lookup launches of one forward: one a subgroup
  and chunk round (``overlap_chunks``; one a subgroup unchunked)."""
  return sum(len(dist._chunk_bounds(s.n_cap))
             for s in dist._subgroups(tuple(hotness)))


def check_equal(tag, got, want):
  """Two lists of tensors equal bit for bit (dtype and shape too)."""
  if len(got) != len(want):
    raise AssertionError(f'{tag}: {len(got)} tensors against {len(want)}')
  for i, (g, w) in enumerate(zip(got, want)):
    if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
      err = (float((g.float() - w.float()).abs().max())
             if g.shape == w.shape else None)
      raise AssertionError(f'{tag} {i}: the chunked arm differs from the '
                           f'unchunked one (max abs err {err})')


def check_hybrid_states(tag, dist_a, a, dist_b, b):
  """Two hybrid (or dense) train states equal bit for bit: every
  canonical table, every sparse-optimizer leaf in the global layout, the
  dense params and the dense optimizer state."""
  for t, (x, y) in enumerate(zip(
      checkpoint.get_weights(dist_a, a.params['embedding']),
      checkpoint.get_weights(dist_b, b.params['embedding']))):
    same, err = compare_tables(x, y)
    if not same:
      raise AssertionError(f'{tag} table {t}: differs, max err {err}')
  dense_a = {k: v for k, v in a.params.items() if k != 'embedding'}
  dense_b = {k: v for k, v in b.params.items() if k != 'embedding'}
  check_equal(f'{tag} dense params', [dense_a[k] for k in sorted(dense_a)],
              [dense_b[k] for k in sorted(dense_a)])
  opt_a, opt_b = a.opt_state, b.opt_state
  if isinstance(opt_a, tuple):  # the hybrid step's (dense, sparse)
    for t, (x, y) in enumerate(zip(
        checkpoint.get_optimizer_state(dist_a, opt_a[1]),
        checkpoint.get_optimizer_state(dist_b, opt_b[1]))):
      for k in x:
        same, err = compare_tables(x[k].float(), y[k].float())
        if not same:
          raise AssertionError(f'{tag} table {t} state {k}: differs, max '
                               f'err {err}')
    opt_a, opt_b = opt_a[0], opt_b[0]
  as_rows = lambda x: x.reshape(x.shape[0] if x.dim() else 1, -1)
  for i, (x, y) in enumerate(zip(optim.tree_leaves(opt_a),
                                 optim.tree_leaves(opt_b))):
    same, err = compare_tables(as_rows(x), as_rows(y))
    if not same:
      raise AssertionError(f'{tag} dense optimizer leaf {i}: differs, max '
                           f'err {err}')


def close_tables(a, b, rtol, atol):
  """``(all close, max abs difference)`` of two table-shaped tensors,
  compared in row blocks (no table-sized temporary)."""
  ok, err = True, 0.0
  for r0 in range(0, a.shape[0], CHECK_BLOCK_ROWS):
    x = a[r0:r0 + CHECK_BLOCK_ROWS].float()
    y = b[r0:r0 + CHECK_BLOCK_ROWS].float()
    ok = ok and torch.allclose(x, y, rtol=rtol, atol=atol)
    err = max(err, float((x - y).abs().max()))
  return ok, err


def captured_hot_step(step, state, cats, batch):
  """One real cached training step that also records the arguments of
  its lookups (the cold-row gathers, ``fused_group_lookup``, and the hot
  partials, ``dense_lookup``), of its segment sums
  (``routing.segment_sum``) and, as ``captured_compact_applies`` does,
  of its applies."""
  gathers, partials, sums = [], [], []
  fused, dense, segsum = (lookup.fused_group_lookup, lookup.dense_lookup,
                          routing.segment_sum)

  def record_fused(table, routed, combiners, compute_dtype, scale=None):
    gathers.extend((table, r) for r in routed)
    return fused(table, routed, combiners, compute_dtype, scale)

  def record_dense(table, ids, combiner, out_dtype=None, scale=None):
    partials.append((table, ids))
    return dense(table, ids, combiner, out_dtype, scale)

  def record_sum(seg, rows, num, row_index=None):
    sums.append((seg, rows, num, row_index))
    return segsum(seg, rows, num, row_index)

  lookup.fused_group_lookup = record_fused
  lookup.dense_lookup = record_dense
  routing.segment_sum = record_sum
  try:
    state, loss, applies = captured_compact_applies(step, state, cats, batch)
  finally:
    lookup.fused_group_lookup = fused
    lookup.dense_lookup = dense
    routing.segment_sum = segsum
  return state, loss, {'gathers': gathers, 'partials': partials,
                       'sums': sums, 'applies': applies}


def phase_hot_serving(model, serve_sets, cats, rng):
  """Phase 9e's serving part: an engine with the serving hot sets and
  one without, over the model's tables; requests of ``REQUEST_SIZES``
  samples; every answer of the cached engine equal to the other's
  (bit-exact hotness 1, 1e-6 hotness 10), every cold gather and hot
  partial on the lookup kernel (counted).  Returns the launches and the
  request times."""
  dist = model.dist_embedding
  weights = checkpoint.get_weights(dist, model.embedding_params)
  common = dict(batch_size=SERVE_BATCH, device=dist.device,
                input_table_map=model.input_table_map, hotness=model.hotness)
  hot = ServingEngine(dist.table_configs, weights, hot_sets=serve_sets,
                      **common)
  plain = ServingEngine(dist.table_configs, weights, **common)
  del weights
  sample = [c[:SERVE_BATCH] for c in cats]
  hot.warmup(sample_cats=sample)
  plain.warmup(sample_cats=sample)
  per_lookup, _ = hot_launches(hot.dist, model.hotness)
  batch = np.asarray(cats[0]).shape[0]
  times = {n: [] for n in REQUEST_SIZES}
  launches = {'lookup_combine': 0, 'segwalk_apply': 0}
  for n in REQUEST_SIZES:
    for _ in range(5):
      start = int(rng.integers(0, batch - n + 1))
      req = [c[start:start + n] for c in cats]
      reset_launches()
      t0 = time.perf_counter()
      got = hot.lookup_padded(req)
      torch.cuda.synchronize()
      times[n].append((time.perf_counter() - t0) * 1e3)
      for k, v in read_launches().items():
        launches[k] += v
      want = plain.lookup_padded(req)
      for i, (g, w, h) in enumerate(zip(got, want, model.hotness)):
        same = (torch.equal(g, w) if h == 1 else
                torch.allclose(g, w, rtol=1e-6, atol=1e-6))
        if not same:
          raise AssertionError(f'hot-serving request of {n}: input {i} '
                               'differs from the engine without hot sets')
  lookups = 5 * len(REQUEST_SIZES)
  want = {k: v * lookups for k, v in per_lookup.items()}
  if launches != want:
    raise AssertionError(f'hot-serving: launched {launches}, expected '
                         f'{want} for {lookups} lookups')
  for n, t in times.items():
    log(f'[hot-serving] request of {n} samples: ms {[round(x, 3) for x in t]}'
        f' median {statistics.median(t):.3f} (host clock, synchronised)')
  log(f'[hot-serving] {lookups} answers equal the engine without hot sets '
      '(bit-exact hotness 1, 1e-6 hotness 10); kernel launches '
      f'{json.dumps(launches)}; hot buffers '
      f'{sum(g.hot_rows_cap * g.width * 4 for g in hot.dist.plan.groups) / 2**20:.1f}'
      ' MiB')
  return {'launches': launches,
          'request_ms_median': {n: statistics.median(t)
                                for n, t in times.items()}}


def phase_hot_tiny(model, config, seed):
  """Phase 9e: the hot-row cache on the tiny model at full size (see the
  module docstring).  Returns the numbers and the kernel rows."""
  dist = model.dist_embedding
  hotness = tuple(model.hotness)
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(hotness))
  tables, _, _ = expand_tables(config)
  train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                    HOT_COVERAGE)
  serve_sets = hotcache.analytic_power_law_hot_sets(
      tables, HOT_ALPHA, coverage=SERVE_HOT_COVERAGE,
      budget_bytes=SERVE_HOT_BUDGET, state_copies=0)
  numbers = {'train_sets': {
      'tables': len(train_sets),
      'rows': sum(h.size for h in train_sets.values()),
      'largest': max(h.size for h in train_sets.values())},
             'serve_sets': {'tables': len(serve_sets),
                            'rows': sum(h.size for h in serve_sets.values())}}
  log(f'[hot-tiny] hot sets: training analytic_power_law_hot_sets(alpha '
      f'{HOT_ALPHA}, coverage {HOT_COVERAGE}) {json.dumps(numbers["train_sets"])}; '
      f'serving (coverage {SERVE_HOT_COVERAGE}, {SERVE_HOT_BUDGET >> 20} MiB, '
      f'state_copies=0) {json.dumps(numbers["serve_sets"])}')

  model.embedding_params = {}
  gc.collect()
  torch.cuda.empty_cache()
  model.init(seed + 17)
  hot_model = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                             device='cuda').init(seed + 17)
  hdist = hot_model.dist_embedding
  fwd_want, step_want = hot_launches(hdist, hotness)
  hot_mib = sum(t.numel() * t.element_size()
                for k, t in hot_model.embedding_params.items()
                if k.startswith('hot_')) / 2**20
  log(f'[hot-tiny] the cached model drawn from the same seed: hot buffers '
      f'{hot_mib:.1f} MiB over {len(hdist.plan.hot_groups)} groups; a '
      f'forward launches {json.dumps(fwd_want)}, a step {json.dumps(step_want)}')
  batches = train_batches(config, hotness, seed + 17, TRAIN_STEPS + 3)
  cats = batches[0][0]

  # forward: the cached layer against the uncached one
  with torch.no_grad():
    reset_launches()
    got = hdist.apply(hot_model.embedding_params, cats)
    fwd_launches = read_launches()
    want = dist.apply(model.embedding_params, cats)
    if fwd_launches != fwd_want:
      raise AssertionError(f'hot-tiny forward: launched {fwd_launches}, '
                           f'expected {fwd_want}')
    err = 0.0
    for i, (g, w, h) in enumerate(zip(got, want, hotness)):
      same = (torch.equal(g, w) if h == 1 else
              torch.allclose(g, w, rtol=1e-6, atol=1e-6))
      if not same:
        raise AssertionError(f'hot-tiny input {i}: the cached forward differs '
                             'from the uncached one (bit-exact hotness 1, '
                             f'1e-6 hotness {h}), max err '
                             f'{float((g - w).abs().max())}')
      err = max(err, float((g - w).abs().max()))
    del got, want
    fwd_ms = {}
    for tag, d, p in (('off', dist, model.embedding_params),
                      ('on', hdist, hot_model.embedding_params)):
      fwd_ms[tag] = []
      for _ in range(3):
        t0 = time.perf_counter()
        d.apply(p, cats)
        torch.cuda.synchronize()
        fwd_ms[tag].append((time.perf_counter() - t0) * 1e3)
  numbers.update(forward_launches=fwd_launches, forward_max_abs_err=err,
                 forward_ms=fwd_ms)
  log(f'[hot-tiny] the cached forward equals the uncached one (bit-exact '
      f'hotness 1; max abs err {err} at hotness 10, within 1e-6); launches '
      f'{json.dumps(fwd_launches)}; forward ms (host clock, synchronised) '
      f'{json.dumps(fwd_ms)}')

  # exchange counters, cache off and on
  t0 = time.perf_counter()
  counters = {'off': hotcache.measure_exchange_counters(dist, cats,
                                                        hot_sets={}),
              'on': hotcache.measure_exchange_counters(hdist, cats)}
  keys = ('alltoall_rows_sent', 'alltoall_rows_sent_off', 'hot_hit_rate',
          'total_id_occurrences', 'scatter_rows_per_step',
          'scatter_rows_per_step_off')
  numbers['counters'] = {tag: {k: c[k] for k in keys}
                         for tag, c in counters.items()}
  log(f'[hot-tiny] exchange counters of batch {BATCH} (host numpy, '
      f'{time.perf_counter() - t0:.1f} s): '
      f'{json.dumps(numbers["counters"])}')

  numbers['serving'] = phase_hot_serving(model, serve_sets, cats,
                                         np.random.default_rng(seed + 17))
  gc.collect()
  torch.cuda.empty_cache()

  # training: the same batches from the same state, cache off and on
  off_step, off_state = build_trainer(model)
  on_step, on_state = build_trainer(hot_model)
  runs = {}
  for tag, per in (('off', {'lookup_combine': n_subs,
                            'segwalk_apply': n_groups}), ('on', step_want)):
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    step, state = (off_step, off_state) if tag == 'off' else (on_step,
                                                               on_state)
    state, launches, times, peak = timed_steps(
        f'hot-tiny-{tag}', step, state, batches,
        {k: v * TRAIN_STEPS for k, v in per.items()})
    if tag == 'off':
      off_state = state
    else:
      on_state = state
    runs[tag] = {'launches': launches, 'step_ms': times,
                 'resident_gib': resident / 2**30, 'peak_gib': peak / 2**30}
  del step, state
  exact, errs = True, {'tables': 0.0, 'acc': 0.0}
  for what, rtol, atol in (('tables', 2e-4, 2e-6), ('acc', 5e-3, 5e-4)):
    if what == 'tables':
      a = checkpoint.get_weights(hdist, on_state.params['embedding'])
      b = checkpoint.get_weights(dist, off_state.params['embedding'])
    else:
      a = [s['acc'] for s in checkpoint.get_optimizer_state(
          hdist, on_state.opt_state[1])]
      b = [s['acc'] for s in checkpoint.get_optimizer_state(
          dist, off_state.opt_state[1])]
    for t, (x, y) in enumerate(zip(a, b)):
      ok, e = close_tables(x, y, rtol, atol)
      same, _ = compare_tables(x, y)
      exact = exact and same
      errs[what] = max(errs[what], e)
      if not ok:
        raise AssertionError(f'hot-tiny {what} {t}: cache on and off differ '
                             f'after {TRAIN_STEPS + 1} steps beyond rtol '
                             f'{rtol} / atol {atol}, max err {e}')
    del a, b
  syncs = {tag: host_syncs(lambda s=s, st=st: s(st, *batches[TRAIN_STEPS + 1]))
           for tag, s, st in (('off', off_step, off_state),
                              ('on', on_step, on_state))}
  numbers['train'] = runs
  numbers['train'].update(max_abs_err=errs, bit_exact=exact, host_syncs={
      tag: sum(c.values()) for tag, c in syncs.items()})
  log(f'[hot-tiny] after {TRAIN_STEPS + 1} steps the canonical tables and '
      f'accumulators of cache on and off agree (tables rtol 2e-4 / atol '
      f'2e-6, accumulators 5e-3 / 5e-4): max abs err {json.dumps(errs)}, '
      f'bit-exact {exact}')
  for tag, c in syncs.items():
    log(f'[hot-tiny] host syncs of one step, cache {tag}: '
        f'{sum(c.values())}, by line {json.dumps(dict(c.most_common()))}')
  # where a cached step's time goes (phase 9 profiles the uncached one)
  phase_train_profile(on_step, on_state, batches[TRAIN_STEPS + 1],
                      tag='profile-hot-train')
  del off_step, off_state
  model.embedding_params = {}
  gc.collect()
  torch.cuda.empty_cache()

  # the kernels on a captured cached step
  on_state, loss, calls = captured_hot_step(on_step, on_state,
                                            *batches[TRAIN_STEPS + 2])
  if not bool(torch.isfinite(loss)):
    raise AssertionError(f'hot-tiny capture step: loss {float(loss)}')
  rows = {'gather': [], 'partial': [], 'add': [], 'apply': []}
  for table, routed in calls['gathers']:
    rows['gather'].append(check_kernel_shape(
        table, routed.reshape(-1, 1),
        f'hot_cold_gather_w{table.shape[1]}_ncap{routed.shape[0]}'))
  for table, ids in calls['partials']:
    rows['partial'].append(check_kernel_shape(
        table, ids, f'hot_partial_w{table.shape[1]}_h{ids.shape[1]}_'
        f'K{table.shape[0]}'))
  for seg, srows, num, row_index in calls['sums']:
    segs = segwalk.sort_stream(seg.to(torch.int32), num,
                               row_index.to(torch.int32))
    rows['add'].append(check_add_stream(
        segs, srows.float(), num, torch.float32,
        f'hot_add_rows{num}_w{srows.shape[1]}', 'hot-tiny'))
  for call in calls['applies']:
    table, grads = call['table'], call['grads']
    label = f'hot_cold_w{table.shape[1]}_rows{table.shape[0]}'
    check_untouched(call, label)
    touched = call['touched'].long()
    err, tol = check_compact(call, 'adagrad_dedup', grads, label, stepped=(
        table[touched], state_rows(call['acc'], touched)))
    err_sgd, _ = check_compact(call, 'sgd', grads, label)
    segs = segwalk.sort_stream(call['ids'], table.shape[0], call['g_index'])
    # timed at lr 0 on the real state (it is not used after this phase)
    kernel_ms = device_ms(lambda: segwalk.apply_segments(
        table, call['acc'], segs, grads, 0.0, op='adagrad_dedup'), 10)
    plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
        table, call['acc'], segs, grads, 0.0, op='adagrad_dedup'))
    row, _ = stream_row(call, 'adagrad_dedup', grads, call['acc'], label,
                        max(err, err_sgd), tol + '; sgd bit-exact',
                        kernel_ms, plain_ms, None)
    log('[hot-tiny] ' + json.dumps(clocked(row)))
    rows['apply'].append(row)
  del calls
  log('[hot-tiny] the captured step\'s kernels equal their plain versions: '
      f'{len(rows["gather"])} cold gathers and {len(rows["partial"])} hot '
      f'partials (bit-exact hotness 1, 1e-6 hotness 10), {len(rows["add"])} '
      f'segment sums (bit-exact), {len(rows["apply"])} cold applies')
  del on_step, on_state
  gc.collect()
  torch.cuda.empty_cache()
  numbers['adam'], rows['add_touch'] = phase_hot_adam(hot_model, config,
                                                      seed, step_want)
  del hot_model
  gc.collect()
  torch.cuda.empty_cache()
  return numbers, rows


def phase_hot_adam(hot_model, config, seed, step_want):
  """Phase 9e's lazy Adam: ``HOT_ADAM_STEPS`` steps of SparseAdam(0.001)
  (Adagrad on the MLP) on the cached layer; every loss finite; per hot
  group, ``t > 0`` exactly at the hot rows the batches name, and every
  other hot row keeps its weights bit for bit and m = v = t = 0.  The
  last step's hot segment sums carry the occurrence count (width ``w +
  1``, the segment walk's narrow vector arm): each against its plain
  version, timed (``check_add_stream``).  Returns the numbers and those
  rows."""
  hdist = hot_model.dist_embedding
  dense_opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)
  emb_opt = sparse.SparseAdam(0.001)
  params = hot_model.embedding_params
  state = sparse.init_hybrid_train_state(
      hdist, {'embedding': params, **hot_model.dense_params()}, dense_opt,
      emb_opt)
  step = sparse.make_hybrid_train_step(hdist, tiny_head_loss(hot_model),
                                       dense_opt, emb_opt)
  batches = train_batches(config, hot_model.hotness, seed + 19,
                          HOT_ADAM_STEPS)
  before = {k: v.clone() for k, v in params.items() if k.startswith('hot_')}
  readers = hdist._hot_meta()['readers']
  named = {gi: torch.zeros(hdist.plan.groups[gi].hot_rows_cap,
                           dtype=torch.bool, device='cuda')
           for gi in hdist.plan.hot_groups}
  for cats, _ in batches:
    inputs, _, _ = hdist._prepare_inputs(cats)
    mem = hdist._hot_membership(inputs)
    for gi, rs in readers.items():
      for i, _, _, off in rs:
        hot = mem[i]['hot']
        named[gi][(hot[hot >= 0] + off).long()] = True
  sums, segsum = [], routing.segment_sum

  def record_sum(seg, rows, num, row_index=None):
    sums.append((seg, rows, num, row_index))
    return segsum(seg, rows, num, row_index)

  reset_launches()
  segwalk.ARM_LAUNCHES.clear()
  losses = []
  routing.segment_sum = record_sum
  try:
    for cats, batch in batches:
      sums.clear()
      state, loss = step(state, cats, batch)
      losses.append(float(loss))
  finally:
    routing.segment_sum = segsum
  launches = {**read_launches(), 'segwalk_apply:adam':
              segwalk.ARM_LAUNCHES['adam']}
  n_applies = len({s.gi for s in hdist._subgroups(tuple(hot_model.hotness))})
  want = {**{k: v * HOT_ADAM_STEPS for k, v in step_want.items()},
          'segwalk_apply:adam': n_applies * HOT_ADAM_STEPS}
  if not all(np.isfinite(losses)) or launches != want:
    raise AssertionError(f'hot-adam: losses {losses}, launched {launches}, '
                         f'expected {want}')
  untouched = 0
  for gi in hdist.plan.hot_groups:
    k = f'hot_group_{gi}'
    st = state.opt_state[1][k]
    cold = ~named[gi]
    if not (torch.equal(st['t'] > 0, named[gi])
            and torch.equal(params[k][cold], before[k][cold])
            and not st['m'][cold].any() and not st['v'][cold].any()):
      raise AssertionError(f'hot-adam {k}: not lazy on the hot rows the '
                           'batches do not name')
    untouched += int(cold.sum())
  log(f'[hot-adam] {HOT_ADAM_STEPS} SparseAdam steps on the cached layer: '
      f'losses {losses}; launches {json.dumps(launches)}; t > 0 exactly at '
      f'the {sum(int(m.sum()) for m in named.values())} hot rows the batches '
      f'name; the other {untouched} kept their weights bit for bit and '
      'm = v = t = 0')
  del state, step
  hot_rows = {g.hot_rows_cap for g in hdist.plan.groups if g.hot_rows_cap}
  rows = []
  for seg, srows, num, row_index in sums:
    if num in hot_rows:  # the hot grads with their count column
      segs = segwalk.sort_stream(seg.to(torch.int32), num,
                                 row_index.to(torch.int32))
      rows.append(check_add_stream(
          segs, srows.float(), num, torch.float32,
          f'hot_add_touch_rows{num}_w{srows.shape[1]}', 'hot-adam'))
  return {'losses': losses, 'launches': launches,
          'untouched_hot_rows': untouched}, rows


def phase_dlrm_hot():
  """Phase 13c: examples/dlrm/main.py --dp_input --hot_cache in process,
  bf16, at phase 13b's onechip vocabularies (the same one cut), 5 steps
  with the state audited after each (so every loss is checked finite)
  and --save_state; verify_checkpoint passes the file, and it restores
  into the same model without the cache with equal canonical tables.
  Returns the launches and numbers."""
  sizes = [min(s, ONECHIP_MAX_ROWS) for s in data.MLPERF_SIZES]
  check_disk(1.2 * sum(sizes) * 128 * 4, 'dlrm-hot')
  root = CKPT_DIR / 'dlrm_hot'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  path = root / 'hot.npz'
  argv = ['--param_dtype', 'bfloat16', '--table_sizes',
          ','.join(map(str, sizes)), '--num_batches', str(DLRM_HOT_STEPS),
          '--max_steps', str(DLRM_HOT_STEPS), '--device', 'cuda',
          '--dp_input', '--hot_cache', '--audit_every', '1',
          '--save_state', str(path)]
  # the launches a step makes, from the plan the example builds
  args = dlrm_main.build_parser().parse_args(argv)
  probe = dlrm.DLRM(sizes, embedding_dim=128, param_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, dp_input=True,
                    hot_cache=dlrm_main.calibrate_hot_sets(args, sizes)[0],
                    device='cuda').dist_embedding
  _, per_step = hot_launches(probe, (1,) * len(sizes))
  del probe
  gc.collect()
  torch.cuda.empty_cache()
  out_lines = _Tee()
  reset_launches()
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(out_lines):
    out = dlrm_main.main(argv)
  wall = time.perf_counter() - t0
  launches = read_launches()
  want = {k: v * DLRM_HOT_STEPS for k, v in per_step.items()}
  calibrated = [l for l in out_lines.lines if l.startswith('hot_cache: ')]
  if launches != want or not calibrated or out['step'] != DLRM_HOT_STEPS:
    raise AssertionError(f'dlrm-hot: launched {launches} (expected {want}), '
                         f'calibration line {calibrated}, step {out["step"]}')
  if verify_checkpoint.main([str(path), '--quiet']) != 0:
    raise AssertionError('dlrm-hot: verify_checkpoint rejected the file')
  gc.collect()
  torch.cuda.empty_cache()
  model = dlrm.DLRM(sizes, embedding_dim=128, param_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, dp_input=True,
                    device='cuda').init(0)
  step, state = dlrm_main.make_trainer(model, 'sparse', args.learning_rate)
  t1 = time.perf_counter()
  state, _ = checkpoint.restore_train_state(model.dist_embedding, state,
                                            str(path))
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t1
  weights, _, _ = checkpoint.load_train_npz(str(path))
  for t, (a, w) in enumerate(zip(checkpoint.get_weights(
      model.dist_embedding, state.params['embedding']), weights)):
    same, e = compare_tables(a.float(), torch.from_numpy(w).to('cuda'))
    if not same:
      raise AssertionError(f'dlrm-hot table {t}: restored without the cache, '
                           f'differs from the file (max err {e})')
  del model, step, state, weights
  gc.collect()
  torch.cuda.empty_cache()
  shutil.rmtree(root)
  numbers = {'rows': sum(sizes), 'calibration': calibrated[0],
             'wall_s': wall, 'loss': out['loss'],
             'save_s': out['save_s'], 'restore_s': restore_s}
  log(f'[dlrm-hot] {json.dumps(numbers)}; launches {json.dumps(launches)} '
      f'({json.dumps(per_step)} a step); verify_checkpoint passed the file; '
      'restored without the cache, the canonical tables equal it')
  return launches, numbers


class _Tee:
  """A stdout that keeps the lines written to it and passes them on."""

  def __init__(self):
    self.lines = []
    self._out = sys.stdout

  def write(self, text):
    self.lines.extend(x for x in text.splitlines() if x)
    return self._out.write(text)

  def flush(self):
    self._out.flush()


def phase_lint_tiny(model, config, seed, card):
  """Phase 9l: graphlint's programs on the tiny model at full size, a
  world of one on the card (``analysis/graphlint.py``): the sparse step
  monolithic and chunked, the dense step's backward, the cached forward,
  the serving ladder and the cold-tier fetch forward, each run under the
  monitors, then every pass under the port's baseline, strict.  Returns
  each program's numbers and the kernels' launches by program."""
  tag = 'lint-tiny'
  t_phase = time.perf_counter()
  dist = model.dist_embedding
  hotness = tuple(model.hotness)
  tables, _, _ = expand_tables(config)
  train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                    HOT_COVERAGE)
  batches = train_batches(config, hotness, seed + 23, LINT_CALLS)
  cats = batches[0][0]
  programs = []

  def free():
    gc.collect()
    torch.cuda.empty_cache()

  # the sparse step, monolithic (phase 9's layer) and chunked
  model.embedding_params = {}
  free()
  model.init(seed + 23)
  step, state = build_trainer(model)
  prog, state = graphlint.train_program('train/monolithic', dist, state,
                                        step, batches, parity='train-step')
  programs.append(prog)
  del step, state
  free()
  chunked = SyntheticModel(config, dp_input=True, overlap_chunks=CHUNKS,
                           device='cuda').init(seed + 23)
  step, state = build_trainer(chunked)
  prog, state = graphlint.train_program(
      'train/chunked', chunked.dist_embedding, state, step, batches,
      parity='train-step')
  programs.append(prog)
  del step, state, chunked
  free()
  # the dense step's backward on phase 9's tables (fresh from the seed)
  model.embedding_params = {}
  free()
  model.init(seed + 23)
  programs.append(graphlint.backward_program(
      'bwd/fused', dist, model.embedding_params, cats, parity='bwd-fuse'))
  free()
  # the serving ladder over phase 9's tables
  engine = ServingEngine(dist.table_configs,
                         checkpoint.get_weights(dist, model.embedding_params),
                         batch_size=SERVE_BATCH, device=dist.device,
                         input_table_map=model.input_table_map,
                         hotness=model.hotness)
  engine.warmup(sample_cats=[c[:SERVE_BATCH] for c in cats])
  programs += graphlint.ladder_programs(
      engine, {rung: [c[:rung] for c in cats] for rung in engine.buckets})
  del engine
  free()
  # the cached forward
  hot = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                       device='cuda').init(seed + 23)
  with torch.no_grad():
    programs.append(graphlint.forward_program(
        'lookup/hot', hot.dist_embedding, hot.embedding_params, cats))
  del hot
  free()
  # the cold-tier fetch forward: int8, under half its resident bytes
  probe = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                         table_dtype='int8', device='cuda').dist_embedding
  budget = int(probe.plan.resident_table_bytes() * LINT_BUDGET)
  tiered = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                          table_dtype='int8', cold_tier=True,
                          device_hbm_budget=budget,
                          device='cuda').init(seed + 23)
  tdist = tiered.dist_embedding
  with torch.no_grad():
    programs.append(graphlint.forward_program(
        'serve/coldfetch', tdist, tiered.embedding_params, cats,
        cold_fetch=lambda: tdist.build_cold_fetch(cats)))
  del tiered, tdist, probe
  free()

  res = graphlint.run_programs(
      programs, baseline=lint_core.Baseline.load(
          lint_core.default_baseline_path()), backend='cuda')
  numbers = {}
  for prog in programs:
    syncs = graphlint.hostsync_counts(prog)
    hbm = res.meta['graphlint_hbm'].get(prog.name, {})
    numbers[prog.name] = {
        'launches': prog.launches,
        'calls': prog.hostsync.calls if prog.hostsync else None,
        'builds_after_warmup': prog.retrace.builds if prog.retrace else None,
        'donation': (None if prog.donation is None else
                     {'leaves': len(prog.donation),
                      'inplace': sum(ok for _, ok in prog.donation)}),
        'resident_gib': (None if hbm.get('resident_state') is None
                         else hbm['resident_state'] / 2**30),
        'budget_gib': (None if hbm.get('budget') is None
                       else hbm['budget'] / 2**30),
        'peak_gib': (None if prog.peak_bytes is None
                     else prog.peak_bytes / 2**30),
        'syncs': syncs}
    n = numbers[prog.name]
    log(f'[{tag}] {prog.name}: launches {json.dumps(prog.launches)} over '
        f'{syncs.get("calls")} monitored call(s); builds after warm-up '
        f'{n["builds_after_warmup"]}; donation {json.dumps(n["donation"])}; '
        f'resident {n["resident_gib"]} GiB, budget {n["budget_gib"]} GiB, '
        f'peak {n["peak_gib"]} GiB')
    log(f'[{tag}] {prog.name}: host syncs a call: wrapped calls '
        f'{syncs.get("per_call")} {json.dumps(syncs.get("sites"))}; sync '
        f'debug mode {syncs.get("device_per_call")} '
        f'{json.dumps(syncs.get("device_sites"))}; only the debug mode '
        f'{syncs.get("only_device")}, only the wrapped calls '
        f'{syncs.get("only_wrapped")}')
  c = res.counts
  log(f'[{tag}] card {card}: {c["findings"]} finding(s), '
      f'{c["unverifiable"]} unverifiable, {c["waived"]} waived, '
      f'{c["stale_waivers"]} stale, {c["expired_waivers"]} expired over '
      f'{len(programs)} programs; waived {[f.id for f in res.waived]}')
  for f in res.findings:
    log(f'[{tag}] FINDING {f.id}: {f.message}')
  if (res.findings or res.unverifiable or res.stale_waivers
      or res.expired_waivers):
    raise AssertionError(
        f'{tag}: graphlint is not strict-clean on the card: findings '
        f'{[f.id for f in res.findings + res.unverifiable]}, stale '
        f'{res.stale_waivers}, expired {res.expired_waivers}')
  # the catalog's own small programs on the card, as the CLI runs them
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = graphlint_cli.main(['--strict', '--json'])
  small = json.loads(out.getvalue())
  log(f'[{tag}] python -m distributed_embeddings_tpu_torch.tools.graphlint '
      f'--strict on the card: exit {rc}, {json.dumps(small["counts"])} over '
      f'{len(small["meta"]["graphlint_programs"])} programs')
  if rc != 0:
    raise AssertionError(f'{tag}: graphlint --strict exited {rc} on the card: '
                         f'{[f["id"] for f in small["findings"]]}, stale '
                         f'{small["stale_waivers"]}')
  launched = {name: sum(p.launches.get(name, 0) for p in programs)
              for name in ('lookup_combine', 'segwalk_apply')}
  if not all(launched.values()):
    raise AssertionError(f'{tag}: the programs launched {launched}')
  log(f'[{tag}] strict-clean in {time.perf_counter() - t_phase:.1f} s; '
      f'kernel launches over the monitored calls {json.dumps(launched)}')
  return {'programs': numbers, 'launches': {
      name: {p.name: p.launches.get(name, 0) for p in programs}
      for name in ('lookup_combine', 'segwalk_apply')}}


def run_tiny(args, card):
  """Phases 3-9k on the synthetic tiny model; returns the two kernels'
  summaries.  Everything the model holds on the card is freed on
  return."""
  config = SYNTHETIC_MODELS[MODEL]
  t0 = time.perf_counter()
  model = SyntheticModel(config, dp_input=True, device='cuda').init(
      args.seed)
  torch.cuda.synchronize()
  log(f'[model] {config.name}: {len(model.dist_embedding.table_configs)} '
      f'tables, {model.dist_embedding.num_inputs} inputs, '
      f'{model.total_table_gib():.3f} GiB f32, drawn on the card in '
      f'{time.perf_counter() - t0:.2f} s')
  rng = np.random.default_rng(args.seed)
  (numerical, cats), _ = InputGenerator(config, BATCH, alpha=1.05,
                                        num_batches=1, seed=args.seed)[0]
  cats = pad_multi_hot(cats, model.hotness, rng)

  rows, bf16_row = phase_kernels(model, numerical, cats)
  weights, forward_launches = phase_forward(model, numerical, cats)
  phase_profile(model, numerical, cats)
  serve_launches = phase_serving(model, weights, cats, rng)
  del weights
  elapsed('phases 3-6')
  step, state, calls, profile_batch, train_launches, train_ms = phase_train(
      model, config, args.seed)
  seg_rows, seg_bf16 = phase_segwalk(calls)
  del calls
  torch.cuda.empty_cache()
  train_profile = phase_train_profile(step, state, profile_batch)
  del step, state
  torch.cuda.empty_cache()
  elapsed('phases 7-9')
  adam_launches, adam_rows, adam_times = phase_tiny_adam(model, config,
                                                         args.seed)
  elapsed('phase 9b')
  fit_launches, fit_numbers = phase_fit_tiny(model, config, args.seed)
  elapsed('phase 9c')
  ragged_numbers = phase_ragged_tiny(model, config, args.seed)
  elapsed('phase 9d')
  hot_numbers, hot_rows = phase_hot_tiny(model, config, args.seed)
  elapsed('phase 9e')
  chunked_numbers, chunked_rows = phase_chunked_tiny(model, config, args.seed,
                                                     numerical, cats)
  elapsed('phase 9f')
  obs_numbers = phase_obs_tiny(model, config, args.seed, cats, card,
                               dict(train_profile, step_ms=train_ms))
  elapsed('phase 9k')
  lint_numbers = phase_lint_tiny(model, config, args.seed, card)
  elapsed('phase 9l')

  k = dict(KERNELS[0])
  k.update({
      'launches': train_launches['lookup_combine'],
      'launches_forward': forward_launches['lookup_combine'],
      'launches_serving': serve_launches['lookup_combine'],
      'launches_train': train_launches['lookup_combine'],
      'max_abs_err': max(r['max_abs_err'] for r in rows + [bf16_row]),
      'ms': sum(r['kernel_ms'] for r in rows),
      'plain_ms': sum(r['plain_ms'] for r in rows),
      'bound_ms': sum(r['bound_ms'] for r in rows),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                   else 'operations'),
      'library_ms': sum(r['library_ms'] for r in rows),
  })
  # the training path's op, summed over the groups of one step
  path = [r for r in seg_rows if r['op'] == 'adagrad_dedup']
  sgd = [r for r in seg_rows if r['op'] == 'sgd']
  seg = dict(KERNELS[1])
  seg.update({
      'launches': train_launches['segwalk_apply'],
      'launches_forward': forward_launches['segwalk_apply'],
      'launches_serving': serve_launches['segwalk_apply'],
      'launches_train': train_launches['segwalk_apply'],
      'max_abs_err': max(r['max_abs_err'] for r in seg_rows + [seg_bf16]),
      'ms': sum(r['kernel_ms'] for r in path),
      'plain_ms': sum(r['plain_ms'] for r in path),
      'bound_ms': sum(r['bound_ms'] for r in path),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in path)
                   else 'operations'),
      'library_ms': None,
      'sgd_ms': sum(r['kernel_ms'] for r in sgd),
      'sgd_library_ms': sum(r['library_ms'] for r in sgd),
      'longest_segment': {r['stream']: r['longest_segment'] for r in path},
      'chunk': segwalk.CHUNK,
      'chunks': {r['stream']: r['chunks'] for r in path},
  })
  adam = summed(ARMS[2], adam_launches['segwalk_apply:adam'], adam_rows,
                {'step_ms': adam_times})
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_fit_tiny'] = {run: n[name]
                                  for run, n in fit_launches.items()}
    entry['launches_ragged_tiny'] = ragged_numbers['launches'][name]
  seg['fit_tiny'] = fit_numbers
  k['ragged_tiny'] = ragged_numbers
  # phase 9e: each path's launches, and its kernel shapes beside the bound
  lookup_rows = hot_rows['gather'] + hot_rows['partial']
  seg_rows = hot_rows['add'] + hot_rows['add_touch'] + hot_rows['apply']
  for entry, name, rows in ((k, 'lookup_combine', lookup_rows),
                            (seg, 'segwalk_apply', seg_rows)):
    entry['launches_hot_tiny'] = {
        'forward': hot_numbers['forward_launches'][name],
        'serving': hot_numbers['serving']['launches'][name],
        'train': hot_numbers['train']['on']['launches'][name],
        'adam': hot_numbers['adam']['launches'][name]}
    entry['max_abs_err'] = max([entry['max_abs_err']]
                               + [r['max_abs_err'] for r in rows])
    entry['hot_tiny'] = {
        'ms': sum(r['kernel_ms'] for r in rows),
        'plain_ms': sum(r['plain_ms'] for r in rows),
        'bound_ms': sum(r['bound_ms'] for r in rows),
        'library_ms': (None if any(r['library_ms'] is None for r in rows)
                       else sum(r['library_ms'] for r in rows)),
        'shapes': [{key: r.get(key) for key in (
            'shape', 'stream', 'op', 'w', 'M', 'h', 'rows', 'positions',
            'segments', 'kernel_ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by', 'max_abs_err')} for r in rows]}
  seg['hot_tiny_numbers'] = hot_numbers
  # phase 9f: the chunked forward's launch shapes beside the unchunked
  chunked_summary(k, seg, 'chunked_tiny', chunked_numbers, chunked_rows, {
      'forward': 'forward_launches', 'sparse': 'sparse', 'hot': 'hot',
      'dense': 'dense'})
  # phase 9k: the traced steps' launches
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_obs_tiny'] = {
        arm: n[name] for arm, n in obs_numbers['launches'].items()}
    # phase 9l: each program's launches over its monitored calls
    entry['launches_lint_tiny'] = lint_numbers['launches'][name]
  seg['obs_tiny'] = obs_numbers
  seg['lint_tiny'] = lint_numbers['programs']
  return k, seg, adam


def report_gate(tag, path, require):
  """The port's trace_report on ``path`` with ``--strict --require``
  (its report printed); a non-zero exit fails the phase.  Returns the
  analysis."""
  rc = trace_report.main([str(path), '--strict', '--require', require])
  if rc != 0:
    raise AssertionError(f'{tag}: trace_report --strict --require exited '
                         f'{rc} on {path}')
  return trace_report.report(trace_report.load_trace(str(path)))


# which programs each step phase is made from (obs/devprof.py)
PHASE_PROGRAMS = {'dev/fwd/exchange': ('exf',),
                  'dev/fwd/lookup_combine': ('fwd', 'exf'),
                  'dev/bwd/exchange': ('exb',),
                  'dev/bwd/grad': ('fwdbwd', 'fwd', 'exb'),
                  'dev/apply/update': ('apply',)}


def phase_obs_tiny(model, config, seed, cats, card, train_ref):
  """Phase 9k: the obs layer on the tiny model phase 9 built (f32,
  dp_input, no cache, no tier).  ``train_ref``: phase 9's profile of a
  step (its host syncs) and its timed steps."""
  tag = 'obs-tiny'
  dist = model.dist_embedding
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  want = {'lookup_combine': n_subs * OBS_STEPS,
          'segwalk_apply': len(dist.plan.groups) * OBS_STEPS}
  batches = train_batches(config, model.hotness, seed + 11, OBS_STEPS)
  shutil.rmtree(OBS_DIR, ignore_errors=True)
  OBS_DIR.mkdir(parents=True)
  train_path = OBS_DIR / 'train.json'
  runs = {}
  for traced in (False, True):
    model.embedding_params = {}
    gc.collect()
    torch.cuda.empty_cache()
    model.init(seed)
    step, state = build_trainer(model)
    times = []

    def timed(state, *args, step=step, times=times):
      t0 = time.perf_counter()
      out = step(state, *args)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      return out

    if traced:
      obs.enable(trace_path=str(train_path))
    reset_launches()
    state, hist = grad.fit(timed, state, iter(batches), steps=OBS_STEPS,
                           log_every=1, verbose=False, dist=dist)
    torch.cuda.synchronize()
    runs[traced] = {'loss': hist['loss'], 'launches': read_launches(),
                    'step_ms': times}
    if traced:
      obs_trace.save()
      obs.reset()
    del step, state
  for traced, run in runs.items():
    if run['launches'] != want:
      raise AssertionError(f'{tag}: {"traced" if traced else "untraced"} '
                           f'steps launched {run["launches"]}, expected '
                           f'{want}')
  if runs[True]['loss'] != runs[False]['loss']:
    raise AssertionError(f'{tag}: traced losses {runs[True]["loss"]} differ '
                         f'from untraced {runs[False]["loss"]}')
  log(f'[{tag}] card {card}; {OBS_STEPS} sparse steps through fit, untraced '
      f'then traced from the same draw: launches {json.dumps(want)} each, '
      f'losses bit-equal {runs[True]["loss"]}; step ms (host clock, '
      f'synced) untraced {[round(t, 3) for t in runs[False]["step_ms"]]}, '
      f'traced {[round(t, 3) for t in runs[True]["step_ms"]]}')
  rep = report_gate(tag, train_path, OBS_REQUIRE)
  train_phases = {n: p['total_ms'] / OBS_STEPS
                  for n, p in rep['phases'].items()}
  log(f'[{tag}] traced step, ms a step: '
      + ', '.join(f'{n} {v:.3f}' for n, v in sorted(train_phases.items()))
      + f'; critical path {json.dumps(rep["critical_path"])}')

  # the segmented-dispatch profile, on a private clone of the tables
  obs.enable(trace_path=str(OBS_DIR / 'devprof.json'))
  prof = devprof.profile_step(dist, cats, params=model.embedding_params,
                              reps=PROFILE_REPS)
  obs_trace.save()
  obs.reset()
  if prof.step_ms <= 0 or any(v < 0 for v in prof.phases.values()):
    raise AssertionError(f'{tag}: devprof phases {prof.phases}, step '
                         f'{prof.step_ms} ms')
  dev_rep = report_gate(tag, OBS_DIR / 'devprof.json',
                        ','.join(devprof.STEP_PHASES))
  if not dev_rep['critical_path']['device_ms'] > 0:
    raise AssertionError(f'{tag}: no device lane in the report')
  dev_phases = devprof.device_phases(prof)
  for name in devprof.STEP_PHASES:
    clocks = ', '.join(f'{p} {prof.device[p]["clock"]}'
                       for p in PHASE_PROGRAMS[name])
    log(f'[{tag}] {name}: {prof.phases[name]:.4f} ms synced wall, '
        f'{dev_phases[name]:.4f} ms device clock ({clocks}); '
        f'{"measured" if prof.direct[name] else "derived"}')
  step_dev = prof.device['step']
  ref_ms = statistics.median(train_ref['step_ms'])
  log(f'[{tag}] the embedding step as one program: {prof.step_ms:.4f} ms '
      f'synced wall, {step_dev["ms"]:.4f} ms device clock '
      f'({step_dev["clock"]}); coverage {prof.coverage_pct} % of the wall; '
      f'beside phase 9\'s whole step (MLP included) {ref_ms:.3f} ms median '
      f'(host clock, synced) and its {train_ref["host_syncs"]} host syncs; '
      f'cost: {prof.cost_note}')
  overhead = obs.measure_overhead(ref_ms)
  log(f'[{tag}] obs.measure_overhead at {ref_ms:.3f} ms a step: '
      f'{json.dumps(overhead)}')
  numbers = {
      'launches': {('traced' if t else 'untraced'): r['launches']
                   for t, r in runs.items()},
      'step_ms': {('traced' if t else 'untraced'): r['step_ms']
                  for t, r in runs.items()},
      'train_phase_ms': train_phases,
      'critical_path': rep['critical_path'],
      'devprof': {'phases': prof.phases, 'device_phases': dev_phases,
                  'device': prof.device, 'step_ms': prof.step_ms,
                  'coverage_pct': prof.coverage_pct},
      'phase9_step_ms': ref_ms, 'phase9_host_syncs': train_ref['host_syncs'],
      **overhead,
  }
  log(f'[{tag}] ' + json.dumps(numbers))
  shutil.rmtree(OBS_DIR)
  return numbers


def chunked_summary(k, seg, key, numbers, rows, paths):
  """Phase 9f's or 13d's entries of the summary line: each path's
  launches chunked and unchunked (``paths`` maps a path to its entry of
  ``numbers``), and under the lookup's ``key`` the chunked forward's
  launch shapes, their times summed beside the unchunked launches' and
  the bound."""
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry[f'launches_{key}'] = {
        path: {arm: numbers[n][arm].get('launches', numbers[n][arm])[name]
               for arm in ('unchunked', 'chunked')}
        for path, n in paths.items()}
    entry['max_abs_err'] = max([entry['max_abs_err']] + [
        r['max_abs_err'] for arm in rows.values() for r in arm])
  k[key] = {arm: kernel_sum(r) for arm, r in rows.items()}
  k[key]['numbers'] = numbers


def chunked_kernel_rows(tag, model, numerical, cats):
  """Every lookup launch of one forward of ``model`` (captured from the
  forward) against its plain version, timed beside its bound
  (``check_kernel_shape``)."""
  return [check_kernel_shape(
      t, r.reshape(-1, r.shape[-1]),
      f'{tag}_w{t.shape[1]}_h{r.shape[-1]}_n{r.shape[0]}')
          for t, r, _ in captured_lookups(model, numerical, cats)]


def kernel_sum(rows):
  """Times and bounds of a forward's launches, summed."""
  return {'launches': len(rows),
          'shapes': [[r['M'], r['h'], r['w']] for r in rows],
          **{k: sum(r[k] for r in rows)
             for k in ('kernel_ms', 'plain_ms', 'library_ms', 'bound_ms')},
          'max_abs_err': max(r['max_abs_err'] for r in rows)}


def step_arms(tag, arms, batches, want, n_steps=TRAIN_STEPS):
  """``timed_steps`` for each ``(name, build)`` arm on the same batches,
  ``build()`` making its ``(step, state)`` just before it runs (so no
  initial state outlives its arm), each arm's launches as ``want[name]``;
  returns per arm its step, final state, launches, times, peak above
  what was resident before it was built, and its losses (the warm-up's
  first)."""
  out = {}
  for name, build in arms:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    step, state = build()
    losses = []
    state, launches, times, peak = timed_steps(
        f'{tag}-{name}', step, state, batches, want[name], n_steps,
        losses_out=losses)
    out[name] = {'step': step, 'state': state, 'launches': launches,
                 'step_ms': times,
                 'peak_gib': peak / 2**30,
                 'peak_above_resident_gib': (peak - resident) / 2**30,
                 'losses': losses}
  return out


def exchange_stats(tag, arms, cats, off_ms, on_ms):
  """``measure_exchange_ms`` of each ``(name, dist)`` arm and the
  overlap A/B record.  On one card there is no collective: the
  exchange program times buffer plumbing only."""
  exch = {name: overlap.measure_exchange_ms(d, cats) for name, d in arms}
  stats = overlap.a2a_overlap_stats(
      off_ms, on_ms, exch['chunked'], CHUNKS,
      overlap.group_chunk_counts(dict(arms)['chunked'].plan))
  # a world of one has no all_to_all to hide: the derived share would be
  # read from host noise in the step times, so it is not reported
  stats['a2a_overlap_pct'] = None
  log(f'[{tag}] world of one: no collective, so a2a_overlap_pct is not '
      'applicable (null): its numerator would be the difference of two '
      'step times that run the same work, host noise')
  log(f'[{tag}] measure_exchange_ms {json.dumps(exch)} (the exchange '
      'program, buffer plumbing only); a2a_overlap_stats '
      f'{json.dumps(stats)}')
  return {'exchange_ms': exch, 'a2a': stats}


def phase_chunked_tiny(model, config, seed, numerical, cats):
  """Phase 9f: the chunked exchange (``overlap_chunks=CHUNKS``) on the
  tiny model at full size against the unchunked layer (see the module
  docstring).  Returns the numbers and the chunked and unchunked
  forwards' kernel rows."""
  tables, itm, _ = expand_tables(config)
  hotness = tuple(model.hotness)
  model.embedding_params = {}
  gc.collect()
  torch.cuda.empty_cache()
  model.init(seed + 19)
  chunked = SyntheticModel(config, dp_input=True, overlap_chunks=CHUNKS,
                           device='cuda').init(seed + 19)
  dist, cdist = model.dist_embedding, chunked.dist_embedding
  n_caps = [s.n_cap for s in dist._subgroups(hotness)]
  per_fwd = {'unchunked': chunk_rounds(dist, hotness),
             'chunked': chunk_rounds(cdist, hotness)}
  n_groups = len(dist.plan.groups)
  numbers = {'chunks': CHUNKS, 'n_caps': n_caps,
             'rounds': [len(cdist._chunk_bounds(n)) for n in n_caps],
             'group_chunks': overlap.group_chunk_counts(cdist.plan),
             'lookups_a_forward': per_fwd}
  log(f'[chunked-tiny] overlap_chunks={CHUNKS}: subgroups of {n_caps} slots '
      f'take {numbers["rounds"]} rounds: {per_fwd["chunked"]} lookup '
      f'launches a forward against {per_fwd["unchunked"]}')
  check_equal('chunked-tiny drawn tables',
              [chunked.embedding_params[k] for k in sorted(
                  chunked.embedding_params)],
              [model.embedding_params[k] for k in sorted(
                  model.embedding_params)])

  # forwards: the same tables through both layers, and the per-group
  # schedule
  per_group = DistributedEmbedding(
      tables, strategy='memory_balanced', dp_input=True,
      input_table_map=itm, device='cuda', overlap_chunks=CHUNKS,
      fused_exchange=False)
  outs, launches, fwd_ms = {}, {}, {}
  with torch.no_grad():
    for name, d in (('unchunked', dist), ('chunked', cdist),
                    ('per_group', per_group)):
      reset_launches()
      outs[name] = d.apply(model.embedding_params, cats)
      launches[name] = read_launches()
      fwd_ms[name] = []
      for _ in range(3):
        t0 = time.perf_counter()
        d.apply(model.embedding_params, cats)
        torch.cuda.synchronize()
        fwd_ms[name].append((time.perf_counter() - t0) * 1e3)
    check_equal('chunked-tiny forward', outs['chunked'], outs['unchunked'])
    check_equal('chunked-tiny per-group forward', outs['per_group'],
                outs['unchunked'])
    check_equal('chunked-tiny forward on its own tables',
                cdist.apply(chunked.embedding_params, cats),
                outs['unchunked'])
  del outs, per_group
  for name in ('unchunked', 'chunked'):
    want = {'lookup_combine': per_fwd[name], 'segwalk_apply': 0}
    if launches[name] != want:
      raise AssertionError(f'chunked-tiny {name} forward: launched '
                           f'{launches[name]}, expected {want}')
  numbers.update(forward_launches=launches, forward_ms=fwd_ms)
  log(f'[chunked-tiny] forwards bit-equal at every hotness (chunked, '
      f'per-group schedule); launches {json.dumps(launches)}; forward ms '
      f'(host clock, synchronised) {json.dumps(fwd_ms)}')
  rows = {'chunked': chunked_kernel_rows('chunked_tiny', chunked, numerical,
                                         cats),
          'unchunked': chunked_kernel_rows('unchunked_tiny', model,
                                           numerical, cats)}

  # 1 + TRAIN_STEPS sparse steps each way from the same state
  batches = train_batches(config, hotness, seed + 19, TRAIN_STEPS + 2)
  want = {name: {'lookup_combine': per_fwd[name] * TRAIN_STEPS,
                 'segwalk_apply': n_groups * TRAIN_STEPS}
          for name in per_fwd}
  runs = step_arms('chunked-tiny', [
      ('unchunked', lambda: build_trainer(model)),
      ('chunked', lambda: build_trainer(chunked))], batches, want)
  check_hybrid_states('chunked-tiny sparse', dist,
                      runs['unchunked']['state'], cdist,
                      runs['chunked']['state'])
  check_equal('chunked-tiny losses', runs['chunked']['losses'],
              runs['unchunked']['losses'])
  syncs = {name: sum(host_syncs(lambda r=r: r['step'](
      r['state'], *batches[TRAIN_STEPS + 1])).values())
           for name, r in runs.items()}
  med = {name: statistics.median(r['step_ms']) for name, r in runs.items()}
  numbers['sparse'] = {name: {k: r[k] for k in (
      'launches', 'step_ms', 'peak_gib', 'peak_above_resident_gib')}
                       for name, r in runs.items()}
  numbers['sparse']['host_syncs'] = syncs
  numbers['sparse'].update(exchange_stats(
      'chunked-tiny', [('unchunked', dist), ('chunked', cdist)], cats,
      med['unchunked'], med['chunked']))
  log(f'[chunked-tiny] {TRAIN_STEPS + 1} sparse steps each way: tables, '
      'accumulators, MLP, dense state and every loss bit-equal; median ms '
      f'{json.dumps(med)}; host syncs of one step {json.dumps(syncs)}')
  del runs
  model.embedding_params, chunked.embedding_params = {}, {}
  gc.collect()
  torch.cuda.empty_cache()

  # the hot sets of phase 9e: the cached layer chunked and unchunked
  train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                    HOT_COVERAGE)
  hot = {name: SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                              overlap_chunks=k, device='cuda').init(seed + 19)
         for name, k in (('unchunked', 1), ('chunked', CHUNKS))}
  with torch.no_grad():
    hot_outs, hot_launch = {}, {}
    for name, m in hot.items():
      reset_launches()
      hot_outs[name] = m.dist_embedding.apply(m.embedding_params, cats)
      hot_launch[name] = read_launches()
  check_equal('chunked-tiny cached forward', hot_outs['chunked'],
              hot_outs['unchunked'])
  del hot_outs
  hot_want = {}
  for name, m in hot.items():
    fwd, per_step = hot_launches(m.dist_embedding, hotness)
    if hot_launch[name] != fwd:
      raise AssertionError(f'chunked-tiny cached {name} forward: launched '
                           f'{hot_launch[name]}, expected {fwd}')
    hot_want[name] = {k: v * TRAIN_STEPS for k, v in per_step.items()}
  hruns = step_arms('chunked-tiny-hot', [
      (name, lambda m=m: build_trainer(m)) for name, m in hot.items()],
                    batches, hot_want)
  check_hybrid_states('chunked-tiny cached', hot['unchunked'].dist_embedding,
                      hruns['unchunked']['state'],
                      hot['chunked'].dist_embedding,
                      hruns['chunked']['state'])
  hot_buffers = lambda r: [v for k, v in sorted(
      r['state'].params['embedding'].items()) if k.startswith('hot_')]
  check_equal('chunked-tiny cached hot buffers',
              hot_buffers(hruns['chunked']), hot_buffers(hruns['unchunked']))
  check_equal('chunked-tiny cached losses', hruns['chunked']['losses'],
              hruns['unchunked']['losses'])
  numbers['hot'] = {'forward_launches': hot_launch, **{
      name: {k: r[k] for k in ('launches', 'step_ms', 'peak_gib',
                               'peak_above_resident_gib')}
      for name, r in hruns.items()}}
  log(f'[chunked-tiny] the cached layer (phase 9e\'s hot sets): forward and '
      f'{TRAIN_STEPS + 1} steps bit-equal chunked and unchunked (apply_hot '
      f'in {CHUNKS} row chunks); launches {json.dumps(hot_launch)} a forward')
  del hruns, hot
  gc.collect()
  torch.cuda.empty_cache()

  # the dense step (phase 14's configuration) each way
  def dense_trainer(m):
    m.init(seed + 19)
    opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)

    def loss_fn(params, batch):
      cats_b, (num_b, labels) = batch
      return dlrm.bce_with_logits(m.apply(params, num_b, cats_b), labels)

    return grad.make_train_step(loss_fn, opt), grad.init_train_state(
        {'embedding': m.embedding_params, **m.dense_params()}, opt)

  druns = step_arms('chunked-tiny-dense', [
      ('unchunked', lambda: dense_trainer(model)),
      ('chunked', lambda: dense_trainer(chunked))],
                    [(b,) for b in batches],
                    {name: {'lookup_combine': per_fwd[name] *
                            (CHUNKED_DENSE_STEPS - 1),
                            'segwalk_apply': n_groups *
                            (CHUNKED_DENSE_STEPS - 1)}
                     for name in per_fwd}, n_steps=CHUNKED_DENSE_STEPS - 1)
  check_hybrid_states('chunked-tiny dense', dist,
                      druns['unchunked']['state'], cdist,
                      druns['chunked']['state'])
  check_equal('chunked-tiny dense losses', druns['chunked']['losses'],
              druns['unchunked']['losses'])
  numbers['dense'] = {name: {k: r[k] for k in (
      'launches', 'step_ms', 'peak_gib', 'peak_above_resident_gib')}
                      for name, r in druns.items()}
  log(f'[chunked-tiny] {CHUNKED_DENSE_STEPS} dense steps each way bit-equal '
      '(tables, MLP, Adagrad state, losses); peak above the resident state '
      f'{json.dumps({n: r["peak_above_resident_gib"] for n, r in druns.items()})} GiB')
  del druns
  model.embedding_params, chunked.embedding_params = {}, {}
  gc.collect()
  torch.cuda.empty_cache()
  return numbers, rows


def phase_dlrm_chunked(seed):
  """Phase 13d: the DLRM at the MLPerf sizes in bf16 with
  ``dp_input=True``, one layer chunked (``overlap_chunks=CHUNKS``) and
  one not over the same tables (two copies do not fit the card), then
  the example with ``--dp_input --overlap_chunks`` (see the module
  docstring).  Returns the numbers and the chunked and unchunked
  forwards' kernel rows."""
  kw = dict(embedding_dim=128, param_dtype=torch.bfloat16,
            compute_dtype=torch.bfloat16, dp_input=True,
            dist_strategy='memory_balanced', device='cuda')
  model = dlrm.DLRM(data.MLPERF_SIZES, **kw).init(seed)
  chunked = dlrm.DLRM(data.MLPERF_SIZES, overlap_chunks=CHUNKS, **kw)
  chunked.embedding_params = model.embedding_params
  chunked.bottom_mlp, chunked.top_mlp = model.bottom_mlp, model.top_mlp
  dist, cdist = model.dist_embedding, chunked.dist_embedding
  shapes = lambda d: [(g.width, g.rows_cap, g.combiner) for g in d.plan.groups]
  if shapes(dist) != shapes(cdist):
    raise AssertionError(f'dlrm-chunked: group shapes {shapes(cdist)} '
                         f'against {shapes(dist)}')
  hotness = (1,) * len(data.MLPERF_SIZES)
  per_fwd = {'unchunked': chunk_rounds(dist, hotness),
             'chunked': chunk_rounds(cdist, hotness)}
  numbers = {'groups': shapes(dist),
             'n_caps': [s.n_cap for s in dist._subgroups(hotness)],
             'bounds': [cdist._chunk_bounds(s.n_cap)
                        for s in cdist._subgroups(hotness)],
             'lookups_a_forward': per_fwd}
  log(f'[dlrm-chunked] {sum(data.MLPERF_SIZES):,} rows x 128 bf16 '
      f'({model.total_table_gib():.3f} GiB, one copy), dp_input=True; '
      f'chunks {numbers["bounds"]}: {per_fwd["chunked"]} lookups a '
      f'forward against {per_fwd["unchunked"]}')
  batches = [(input_order(model, c), b) for c, b in dlrm_batches(
      model, seed + 5, TRAIN_STEPS + 2)]
  cats, (numerical, _) = batches[0]
  launches, fwd_ms = {}, {}
  with torch.no_grad():
    for name, d in (('unchunked', dist), ('chunked', cdist)):
      reset_launches()
      fwd_ms[name] = []
      for _ in range(3):
        t0 = time.perf_counter()
        outs = d.apply(model.embedding_params, cats)
        torch.cuda.synchronize()
        fwd_ms[name].append((time.perf_counter() - t0) * 1e3)
        if name == 'unchunked':
          want_outs = outs
        else:
          check_equal('dlrm-chunked forward', outs, want_outs)
      launches[name] = read_launches()
      if launches[name] != {'lookup_combine': 3 * per_fwd[name],
                            'segwalk_apply': 0}:
        raise AssertionError(f'dlrm-chunked {name} forwards launched '
                             f'{launches[name]}')
    del outs, want_outs
    res = {name: d.forward_with_residuals(model.embedding_params, cats)
           for name, d in (('unchunked', dist), ('chunked', cdist))}
    check_equal('dlrm-chunked residual', res['chunked'][1],
                res['unchunked'][1])
    gen = torch.Generator(device='cuda').manual_seed(seed + 6)
    d_outs = [torch.randn(o.shape, generator=gen, device='cuda').to(o.dtype)
              for o in res['unchunked'][0]]
    sig = res['unchunked'][2]
    del res
    check_equal('dlrm-chunked backward_to_mp',
                cdist.backward_to_mp(d_outs, *sig),
                dist.backward_to_mp(d_outs, *sig))
    del d_outs
  log(f'[dlrm-chunked] 3 forwards, the residuals and backward_to_mp '
      f'bit-equal chunked and unchunked; launches {json.dumps(launches)}; '
      f'forward ms (host clock, synchronised) {json.dumps(fwd_ms)}')
  rows = {'chunked': chunked_kernel_rows('dlrm_chunked', chunked, numerical,
                                         cats),
          'unchunked': chunked_kernel_rows('dlrm_unchunked', model,
                                           numerical, cats)}
  # timed steps, each arm from where the one before left the tables
  # (one copy): times and launches, not equality
  runs = step_arms('dlrm-chunked', [
      (name, lambda m=m: dlrm_trainer(m))
      for name, m in (('unchunked', model), ('chunked', chunked))], batches,
                   {name: {'lookup_combine': per_fwd[name] * TRAIN_STEPS,
                           'segwalk_apply': TRAIN_STEPS}
                    for name in per_fwd})
  med = {name: statistics.median(r['step_ms']) for name, r in runs.items()}
  numbers.update(forward_launches=launches, forward_ms=fwd_ms, steps={
      name: {k: r[k] for k in ('launches', 'step_ms', 'peak_gib',
                               'peak_above_resident_gib')}
      for name, r in runs.items()})
  numbers['steps'].update(exchange_stats(
      'dlrm-chunked', [('unchunked', dist), ('chunked', cdist)], cats,
      med['unchunked'], med['chunked']))
  del runs, model, chunked, dist, cdist, batches
  gc.collect()
  torch.cuda.empty_cache()
  numbers['example'] = phase_dlrm_chunked_example()
  return numbers, rows


def phase_dlrm_chunked_example():
  """Phase 13d's example runs: ``examples/dlrm/main.py --dp_input
  --overlap_chunks CHUNKS`` and ``--overlap_chunks 1`` in process at
  phase 13b's onechip vocabularies, ``CHUNKED_EXAMPLE_STEPS`` steps and
  ``--save_state`` each; the two files list the same sha256 for every
  array."""
  sizes = [min(s, ONECHIP_MAX_ROWS) for s in data.MLPERF_SIZES]
  check_disk(1.2 * sum(sizes) * 128 * 4, 'dlrm-chunked')
  root = CKPT_DIR / 'dlrm_chunked'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  common = ['--param_dtype', 'bfloat16', '--table_sizes',
            ','.join(map(str, sizes)), '--num_batches',
            str(CHUNKED_EXAMPLE_STEPS), '--max_steps',
            str(CHUNKED_EXAMPLE_STEPS), '--device', 'cuda', '--dp_input']
  probe = dlrm.DLRM(sizes, embedding_dim=128, param_dtype=torch.bfloat16,
                    dp_input=True, overlap_chunks=CHUNKS,
                    device='cuda').dist_embedding
  lookups = chunk_rounds(probe, (1,) * len(sizes))
  del probe
  out, manifests = {}, {}
  for chunks, per_step in ((CHUNKS, lookups), (1, 1)):
    gc.collect()
    torch.cuda.empty_cache()
    path = root / f'chunks{chunks}.npz'
    reset_launches()
    t0 = time.perf_counter()
    res = dlrm_main.main(common + ['--overlap_chunks', str(chunks),
                                   '--save_state', str(path)])
    wall = time.perf_counter() - t0
    got = read_launches()
    want = {'lookup_combine': per_step * CHUNKED_EXAMPLE_STEPS,
            'segwalk_apply': CHUNKED_EXAMPLE_STEPS}
    if got != want or res['step'] != CHUNKED_EXAMPLE_STEPS:
      raise AssertionError(f'dlrm-chunked example --overlap_chunks {chunks}: '
                           f'launched {got} (expected {want}), step '
                           f'{res["step"]}')
    manifests[chunks] = checkpoint.read_manifest(str(path))['arrays']
    os.remove(path)
    out['chunked' if chunks > 1 else 'unchunked'] = {
        'launches': got, 'wall_s': wall, 'loss': res['loss'],
        'save_s': res['save_s']}
  shutil.rmtree(root)
  if manifests[CHUNKS] != manifests[1]:
    bad = [k for k in manifests[1] if manifests[1][k] != manifests[CHUNKS].get(k)]
    raise AssertionError(f'dlrm-chunked example: the chunked file differs '
                         f'from the unchunked one in {bad}')
  log(f'[dlrm-chunked] the example with --dp_input --overlap_chunks '
      f'{CHUNKS} and with --overlap_chunks 1, {CHUNKED_EXAMPLE_STEPS} steps '
      f'each ({sum(sizes):,} rows, the onechip cut): the files list the same '
      f'sha256 for all {len(manifests[1])} arrays; {json.dumps(out)}')
  return out


def phase_ragged_lookup():
  """Phase 20: the lookup microbenchmark's entry point at its full size
  (``examples/benchmarks/lookup_benchmark.py``: 1 M x 128 f32, 65536
  ragged rows, hotness up to 500), its launches counted from 0; then the
  CSR arm against its plain version on its ids (sum and mean, f32 and a
  bf16 copy), the backward and the sparse SGD against theirs, and the
  arm's kernel, plain, library and bound times.  Returns the arm's
  summary entry."""
  reset_launches()
  t0 = time.perf_counter()
  res = lookup_benchmark.main([])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = {**read_launches(),
              'lookup_combine:csr': lookup.ARM_LAUNCHES['csr']}
  calls = res.calls
  want = {'lookup_combine': calls['ragged_forward'] + calls['dense_grad']
                            + calls['padded_forward'],
          'segwalk_apply': calls['dense_grad'] + calls['sparse_sgd'],
          'lookup_combine:csr': calls['ragged_forward'] + calls['dense_grad']}
  if launches != want:
    raise AssertionError(f'ragged-lookup: launched {launches}, expected '
                         f'{want} for the calls {calls}')
  log(f'[ragged-lookup] the benchmark in {wall:.1f} s: calls '
      f'{json.dumps(calls)}; launches {json.dumps(launches)} (every ragged '
      'forward, the gradient\'s included, on the CSR arm; every backward '
      'and sparse SGD on the segment walk)')
  log(f'[ragged-lookup] ms {json.dumps(res.ms)} ({res.clock})')

  table, r = res.table, res.ragged
  values, splits = r.values, r.row_splits
  vocab, w = table.shape
  nrows, nnz, cap = r.nrows, res.nnz, r.nnz_cap
  lengths = r.row_lengths()
  one_id_rows = bool((lengths == 1).all())
  tol = 'bit-exact' if one_id_rows else 'rtol=atol=1e-6 (sum order)'
  err = 0.0
  for t in (table, table.to(torch.bfloat16)):
    for combiner in ('sum', 'mean'):
      got = lookup.ragged_lookup(t, values, splits, combiner, torch.float32)
      ref = lookup.ragged_lookup_reference(t, values, splits, combiner,
                                           torch.float32)
      torch.cuda.synchronize()
      e = float((got - ref).abs().max())
      err = max(err, e)
      ok = (torch.equal(got, ref) if one_id_rows else
            torch.allclose(got, ref, rtol=1e-6, atol=1e-6))
      if not ok:
        raise AssertionError(f'ragged-lookup: the CSR arm disagrees with its '
                             f'plain version ({t.dtype}, {combiner}), max '
                             f'abs err {e} ({tol})')
  del got, ref

  # the backward: the segment walk's 'add' against the plain version
  gen = torch.Generator(device='cuda').manual_seed(20)
  cot = torch.randn((nrows, w), generator=gen, device='cuda')
  segs, rows = lookup.ragged_grad_stream(values, splits, cot, res.combiner,
                                         vocab)
  kt = lookup._table_grad(segs, rows, vocab, table.dtype)
  pt = torch.zeros_like(kt)
  segwalk.apply_segments_reference(pt, None, segs, rows, 0.0, op='add')
  same, grad_err = compare_tables(kt, pt)
  if not same:
    raise AssertionError(f'ragged-lookup: the backward disagrees with the '
                         f'plain version, max abs err {grad_err} (bit-exact)')
  del kt, pt, cot, segs, rows

  # the sparse SGD: the segment walk's 'sgd' on the ragged stream
  ids, g_index, grads = res.sgd_stream()
  segs = segwalk.sort_stream(ids, vocab, g_index)
  kt, pt = table.clone(), table.clone()
  segwalk.apply_segments(kt, None, segs, grads, lookup_benchmark.LR,
                         op='sgd')
  segwalk.apply_segments_reference(pt, None, segs, grads,
                                   lookup_benchmark.LR, op='sgd')
  same, sgd_err = compare_tables(kt, pt)
  touched = torch.zeros(vocab, dtype=torch.bool, device='cuda')
  touched[segs.sorted_ids[segs.starts].long()] = True
  if not same or not torch.equal(kt[~touched], table[~touched]):
    raise AssertionError(f'ragged-lookup: the sparse SGD disagrees with the '
                         f'plain version (max abs err {sgd_err}) or changed '
                         'an untouched row (bit-exact)')
  del kt, pt, segs, grads

  # the arm's times on the benchmark's shape (f32, its combiner)
  c = res.combiner
  kernel = lambda: lookup.ragged_lookup(table, values, splits, c,
                                        torch.float32)
  plain = lambda: lookup.ragged_lookup_reference(table, values, splits, c,
                                                 torch.float32)
  library = lambda: torch.nn.functional.embedding_bag(
      values, table, splits, mode=c, include_last_offset=True)
  lib_out = library()
  if not torch.allclose(lib_out, kernel(), rtol=1e-5, atol=1e-6):
    raise AssertionError('ragged-lookup: embedding_bag computes another '
                         'function than the CSR arm')
  del lib_out
  # the least bytes, as phase 4 counts them: the ids and splits read
  # once, each DISTINCT row read once, the output written once (a row
  # gathered again may hit L2); every gathered row read once beside it.
  # One f32 add per valid element.
  distinct = int(torch.unique(values[:nnz]).numel())
  row_bytes = w * table.element_size()
  index_bytes = cap * 4 + (nrows + 1) * 4 + nrows * w * 4
  nbytes = distinct * row_bytes + index_bytes
  gathered_bytes = nnz * row_bytes + index_bytes
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = nnz * w / F32_FLOP_PER_S * 1e3
  floor = max(bytes_ms, ops_ms)
  kernel_ms = device_ms(kernel, 20, floor_ms=floor)
  plain_ms = device_ms(plain, 5, floor_ms=floor)
  library_ms = device_ms(library, 20, floor_ms=floor)
  kernel_event_ms = event_ms(kernel, 20)
  row = {
      'shape': f'csr_{nrows}rows_nnz{nnz}_w{w}', 'rows': vocab, 'w': w,
      'batch': nrows, 'nnz': nnz, 'nnz_cap': cap,
      'longest_row': int(lengths.max()), 'distinct_rows': distinct,
      'dtype': 'float32', 'combiner': c, 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': tol, 'backward_max_abs_err': grad_err,
      'sgd_max_abs_err': sgd_err, 'kernel_ms': kernel_ms,
      'kernel_event_ms': kernel_event_ms, 'plain_ms': plain_ms,
      'library_ms': library_ms, 'bound_ms': floor,
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
      'gathered_bytes': gathered_bytes,
      'gathered_bound_ms': gathered_bytes / HBM_BYTES_PER_S * 1e3,
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
  }
  log('[kernels] ' + json.dumps(clocked(row)))
  log('[ragged-lookup] the CSR arm equals its plain version (sum and mean, '
      f'f32 and bf16; {tol}); the backward and the sparse SGD bit-exact, '
      'untouched rows unchanged; embedding_bag with offsets is the library '
      'time')
  entry = dict(CSR_ARM)
  entry.update({
      'launches': launches['lookup_combine:csr'],
      'max_abs_err': max(err, grad_err, sgd_err),
      'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': row['bound_ms'],
      'bound_by': row['bound_by'], 'library_ms': library_ms,
      'gathered_bound_ms': row['gathered_bound_ms'],
      'shape': row['shape'], 'benchmark_ms': res.ms,
      'benchmark_calls': calls, 'launches_benchmark': launches,
  })
  del res, table, values, splits
  gc.collect()
  torch.cuda.empty_cache()
  return entry


def summed(kernel, launches, rows, extra=None):
  """A summary entry: ``kernel``'s name and sources, the path's launch
  count, and the times and bounds summed over ``rows`` (one a stream of
  a step), with each stream's shape."""
  entry = dict(kernel)
  entry.update({
      'launches': launches,
      'max_abs_err': max(r['max_abs_err'] for r in rows),
      'ms': sum(r['kernel_ms'] for r in rows),
      'plain_ms': sum(r['plain_ms'] for r in rows),
      'bound_ms': sum(r['bound_ms'] for r in rows),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                   else 'operations'),
      'library_ms': (None if any(r['library_ms'] is None for r in rows)
                     else sum(r['library_ms'] for r in rows)),
      'streams': [{key: r[key] for key in (
          'stream', 'op', 'dtype', 'stream_dtype', 'acc_dtype', 'rows', 'w',
          'positions', 'segments', 'longest_segment', 'chunks', 'bytes',
          'kernel_ms', 'bound_ms', 'tolerance')} for r in rows],
  })
  entry.update(extra or {})
  return entry


# ------------------------------------------------ quantized table storage


def check_dequant_shape(table, ids, scale, label, library='table'):
  """The dequantizing arm against its plain version at one shape, and
  its timings: kernel, plain, and the library time: ``embedding_bag``
  over the dequantized table (``library='table'``) or over a dequantized
  compact copy of the rows the launch reads, its ids remapped
  (``'compact'``), the dequantization timed inside either way (no
  PyTorch call takes an int8 or fp8 table with per-row scales); None
  times no library call."""
  m, h = ids.shape
  w = table.shape[1]
  lookup.ARM_LAUNCHES['dequant'] = 0
  got = lookup.dense_lookup(table, ids, 'sum', scale=scale)
  want = lookup.dense_lookup_reference(table, ids, 'sum', scale=scale)
  torch.cuda.synchronize()
  if lookup.ARM_LAUNCHES['dequant'] != 1:
    raise AssertionError(f'{label}: the dequantizing arm did not launch')
  err = float((got - want).abs().max()) if m else 0.0
  if h == 1:
    ok, tol = torch.equal(got, want), 'bit-exact'
  else:
    ok = torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    tol = 'rtol=atol=1e-6 (sum order)'
  if not ok:
    raise AssertionError(f'{label}: the dequantizing arm disagrees with '
                         f'its plain version, max abs err {err} ({tol})')
  del got, want
  mask = (ids >= 0) & (ids < table.shape[0])
  safe = torch.where(mask, ids, 0).long()
  valid = int(mask.sum())
  distinct = int(torch.unique(ids[mask]).numel())
  # each id read once, each distinct row's payload and scale once, each
  # output written once; a multiply and an add an element
  row_bytes = w * table.element_size() + 4
  nbytes = m * h * 4 + distinct * row_bytes + m * w * 4
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = 2 * valid * w / F32_FLOP_PER_S * 1e3
  floor = max(bytes_ms, ops_ms)
  kernel = lambda: lookup.dense_lookup(table, ids, 'sum', scale=scale)
  plain = lambda: lookup.dense_lookup_reference(table, ids, 'sum',
                                                scale=scale)
  row = {
      'shape': label, 'M': m, 'h': h, 'w': w,
      'dtype': str(table.dtype).replace('torch.', ''),
      'valid_ids': valid, 'distinct_rows': distinct, 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': tol,
      'kernel_ms': device_ms(kernel, 20, floor_ms=floor),
      'plain_ms': device_ms(plain, 3, floor_ms=floor),
      'library_ms': None,
      'bound_ms': floor,
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
  }
  if library:
    weights = mask.to(torch.float32)
    src, src_scale, src_ids = table, scale, safe
    if library == 'compact':
      read, src_ids = torch.unique(safe, return_inverse=True)
      src = quantization.bits(table)[read].view(table.dtype)
      src_scale = scale[read]
    row['library'] = library
    row['library_ms'] = device_ms(
        lambda: torch.nn.functional.embedding_bag(
            src_ids, quantization.dequantize(src, src_scale), mode='sum',
            per_sample_weights=weights), 5, floor_ms=floor)
  row['achieved_GBps'] = nbytes / (row['kernel_ms'] * 1e-3) / 1e9
  log('[dequant] ' + json.dumps(clocked(row)))
  return row


def quant_gib(params):
  """GiB of a quantized layer's payloads and scales."""
  return sum(t.numel() * t.element_size() for t in params.values()) / 2**30


def captured_quantize(step, state, cats, batch):
  """One real step that also records every requantization (the rows in
  and the payload and scale out) and each quantized group's touched rows
  (the valid ids of its stream)."""
  quants, touched = [], {}
  quantize, apply_q = quantization.quantize, sparse._apply_quantized

  def record_quantize(rows, spec):
    p, sc = quantize(rows, spec)
    quants.append((rows.detach().clone(), p.clone(), sc.clone(), spec))
    return p, sc

  def record_apply(optimizer, spec, payload, scale, state, flat_ids, *a,
                   **k):
    ok = (flat_ids >= 0) & (flat_ids < payload.shape[0])
    touched[payload.data_ptr()] = torch.unique(flat_ids[ok]).long()
    return apply_q(optimizer, spec, payload, scale, state, flat_ids, *a, **k)

  quantization.quantize = record_quantize
  sparse._apply_quantized = record_apply
  try:
    state, loss = step(state, cats, batch)
  finally:
    quantization.quantize = quantize
    sparse._apply_quantized = apply_q
  return state, loss, quants, touched


def check_requant_and_untouched(dist, params, before, quants, touched,
                                tag, max_rows=1 << 18):
  """The card's requantization of a step against the numpy quantizer on
  the host (the first ``max_rows`` rows of each call), and the rows no id
  of the step named unchanged bit for bit, payload and scale.  Returns
  the rows checked and the rows that changed."""
  rows_checked = 0
  for rows, p, sc, spec in quants:
    n = min(rows.shape[0], max_rows)
    want_p, want_s = quantization.quantize_np(rows[:n].cpu().numpy(), spec)
    if not (np.array_equal(p[:n].view(torch.uint8).cpu().numpy(),
                           want_p.view(np.uint8))
            and np.array_equal(sc[:n].cpu().numpy(), want_s)):
      raise AssertionError(f'{tag}: the card\'s requantization differs '
                           'from the numpy quantizer')
    rows_checked += n
  changed = changed_untouched = 0
  for gi in range(len(dist.plan.groups)):
    ids = touched.get(params[f'group_{gi}'].data_ptr())
    for key in (f'group_{gi}', f'scale_group_{gi}'):
      now = quantization.bits(params[key])
      diff = (now != before[key]).reshape(now.shape[0], -1).any(dim=1)
      mask = torch.ones_like(diff)
      if ids is not None:
        mask[ids] = False
      changed += int(diff.sum())
      changed_untouched += int((diff & mask).sum())
  if changed_untouched or not changed:
    raise AssertionError(f'{tag}: {changed} rows changed, '
                         f'{changed_untouched} of them named by no id')
  return rows_checked, changed

def phase_quant_tiny(config, seed, dtype, numerical, cats, rng, ckpt):
  """Phase 9g for one payload dtype (see the module docstring); returns
  its numbers and kernel rows.  Everything it holds on the card is
  freed on return."""
  tag = f'quant-tiny:{dtype}'
  t0 = time.perf_counter()
  model = SyntheticModel(config, dp_input=True, device='cuda',
                         table_dtype=dtype).init(seed)
  torch.cuda.synchronize()
  dist = model.dist_embedding
  hotness = tuple(model.hotness)
  n_subs = len(dist._subgroups(hotness))
  n_groups = len(dist.plan.groups)
  numbers = {'draw_s': time.perf_counter() - t0,
             'table_gib': quant_gib(model.embedding_params)}
  log(f'[{tag}] the tiny model at full size, {dtype} payloads and f32 '
      f'scales: {numbers["table_gib"]:.3f} GiB (f32: '
      f'{model.total_table_gib():.3f} GiB), drawn and quantized on the '
      f'card in {numbers["draw_s"]:.2f} s')
  # the arm against its plain version on the forward's own lookups
  calls = captured_lookups(model, numerical, cats)
  if any(len(c) != 4 for c in calls):
    raise AssertionError(f'{tag}: a lookup went without its scale')
  rows = [check_dequant_shape(t, r.reshape(-1, r.shape[-1]), sc,
                              f'{dtype}_w{t.shape[1]}_h{r.shape[-1]}'
                              f'_ncap{r.shape[0]}')
          for t, r, _, sc in calls]
  del calls
  # the forward: every lookup on the dequantizing arm
  reset_launches()
  with torch.no_grad():
    logits = model(numerical, cats)
  torch.cuda.synchronize()
  fwd = {'lookup_combine': lookup.LAUNCHES,
         'dequant': lookup.ARM_LAUNCHES['dequant'],
         'segwalk_apply': segwalk.LAUNCHES}
  if fwd != {'lookup_combine': n_subs, 'dequant': n_subs,
             'segwalk_apply': 0}:
    raise AssertionError(f'{tag}: the forward launched {fwd}, expected '
                         f'{n_subs} dequantizing lookups')
  if not bool(torch.isfinite(logits).all()):
    raise AssertionError(f'{tag}: logits not finite')
  # a slice of the batch against a plain gather of the dequantized values
  n_check = 512
  weights = checkpoint.get_weights(dist, model.embedding_params)
  head = [c[:n_check] for c in cats]
  with torch.no_grad():
    outs = dist.apply(model.embedding_params, head)
    ref = plain_embedding_outputs(weights, dist.plan.input_table_map, head,
                                  n_check)
  for i, (o, r, h) in enumerate(zip(outs, ref, hotness)):
    same = (torch.equal(o, r) if h == 1 else
            torch.allclose(o, r, rtol=1e-6, atol=1e-6))
    if not same:
      raise AssertionError(f'{tag}: input {i} differs from the plain '
                           'gather of the dequantized tables')
  del outs, ref
  log(f'[{tag}] forward at batch {BATCH}: launches {json.dumps(fwd)}, '
      f'logits finite; the first {n_check} samples equal a plain gather of '
      'the dequantized tables (bit-exact hotness 1, 1e-6 hotness 10)')
  # serving: an engine quantizing the same values equals the model
  serve = phase_serving(model, weights, cats, rng, table_dtype=dtype,
                        tag=tag)
  del weights
  gc.collect()
  torch.cuda.empty_cache()
  # phase 9e's hot sets over the same draw: the cached forward
  tables, _, _ = expand_tables(config)
  train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                    HOT_COVERAGE)
  hot_model = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                             device='cuda', table_dtype=dtype).init(seed)
  hdist = hot_model.dist_embedding
  fwd_want, step_want = hot_launches(hdist, hotness)
  with torch.no_grad():
    reset_launches()
    got = hdist.apply(hot_model.embedding_params, cats)
    hot_fwd = read_launches()
    hot_dequant = lookup.ARM_LAUNCHES['dequant']
    want = dist.apply(model.embedding_params, cats)
  if hot_fwd != fwd_want or hot_dequant != fwd_want['lookup_combine']:
    raise AssertionError(f'{tag}: the cached forward launched {hot_fwd} '
                         f'({hot_dequant} dequantizing), expected '
                         f'{fwd_want}')
  for i, (g, w, h) in enumerate(zip(got, want, hotness)):
    same = (torch.equal(g, w) if h == 1 else
            torch.allclose(g, w, rtol=1e-6, atol=1e-6))
    if not same:
      raise AssertionError(f'{tag}: cached input {i} differs from the '
                           'uncached forward')
  del got, want
  # one cached step (a warm-up, then a counted one)
  hstep, hstate = build_trainer(hot_model)
  hot_batches = train_batches(config, hotness, seed + 19, 2)
  hstate, hloss = hstep(hstate, *hot_batches[0])
  reset_launches()
  hstate, hloss = hstep(hstate, *hot_batches[1])
  torch.cuda.synchronize()
  hot_step = read_launches()
  if hot_step != step_want or not bool(torch.isfinite(hloss)):
    raise AssertionError(f'{tag}: the cached step launched {hot_step} '
                         f'(want {step_want}), loss {float(hloss)}')
  log(f'[{tag}] phase 9e\'s hot sets ({len(train_sets)} tables): the '
      'cached forward equals the uncached one (bit-exact hotness 1, 1e-6 '
      f'hotness 10), launches {json.dumps(hot_fwd)}; a cached step '
      f'launched {json.dumps(hot_step)}, loss {float(hloss):.6f}')
  numbers['hot'] = {'forward': hot_fwd, 'step': hot_step,
                    'loss': float(hloss)}
  del hot_model, hdist, hstep, hstate
  gc.collect()
  torch.cuda.empty_cache()
  # training: phase 7's optimizers, a warm-up and QUANT_STEPS steps
  step, state = build_trainer(model)
  batches = train_batches(config, hotness, seed + 5, QUANT_STEPS + 2)
  torch.cuda.reset_peak_memory_stats()
  state, loss = step(state, *batches[0])
  reset_launches()
  times, losses = [], []
  for batch in batches[1:QUANT_STEPS + 1]:
    t1 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t1) * 1e3)
    losses.append(float(loss))
  launches = {'lookup_combine': lookup.LAUNCHES,
              'dequant': lookup.ARM_LAUNCHES['dequant'],
              'segwalk_apply': segwalk.LAUNCHES}
  want_launches = {'lookup_combine': QUANT_STEPS * n_subs,
                   'dequant': QUANT_STEPS * n_subs,
                   'segwalk_apply': QUANT_STEPS * n_groups}
  if launches != want_launches or not all(np.isfinite(losses)):
    raise AssertionError(f'{tag}: steps launched {launches} (want '
                         f'{want_launches}), losses {losses}')
  peak = torch.cuda.max_memory_allocated()
  log(f'[{tag}] {QUANT_STEPS} steps (SparseAdagrad({LR}), Adagrad on the '
      f'MLP): ms {[round(t, 3) for t in times]} (host clock, '
      f'synchronised), losses {losses}; launches {json.dumps(launches)} '
      '(every lookup on the dequantizing arm, every segment sum on the '
      f'segment walk); peak {peak / 2**30:.3f} GiB')
  numbers.update({'launches': launches, 'step_ms': times, 'losses': losses,
                  'peak_gib': peak / 2**30, 'forward': fwd,
                  'serving': serve})
  # one more step: its requantization against numpy, untouched rows
  emb = state.params['embedding']
  before = {k: quantization.bits(v).clone() for k, v in emb.items()
            if not k.startswith('hot_')}
  state, loss, quants, touched = captured_quantize(
      step, state, *batches[QUANT_STEPS + 1])
  torch.cuda.synchronize()
  checked, changed = check_requant_and_untouched(dist, emb, before, quants,
                                                 touched, tag)
  del before, quants
  log(f'[{tag}] one more step: its requantization equals the numpy '
      f'quantizer on {checked:,} rows (bit for bit, payload and scale); '
      f'{changed:,} rows changed, every one named by an id of the step; '
      'the others kept their bits')
  numbers['host_syncs'] = sum(host_syncs(
      lambda: step(state, *batches[1])).values())
  if ckpt:
    numbers['checkpoint'] = quant_checkpoint(model, step, state, tag, cats,
                                             rng)
  del step, state, model
  gc.collect()
  torch.cuda.empty_cache()
  return numbers, rows


def quant_checkpoint(model, step, state, tag, cats, rng):
  """One quantized checkpoint: save (payload and scale pairs, the
  Adagrad accumulators, the MLP and its optimizer state), restore into a
  fresh draw in place, equal in every logical leaf; then its serving
  bundle (``quant_bundle``); the files deleted."""
  dist = model.dist_embedding
  want = logical_digests(dist, state)
  shutil.rmtree(CKPT_DIR / 'quant', ignore_errors=True)
  (CKPT_DIR / 'quant').mkdir(parents=True, exist_ok=True)
  path = str(CKPT_DIR / 'quant' / 'ckpt.npz')
  check_disk(6e9, tag)
  t0 = time.perf_counter()
  checkpoint.save_train_npz(
      path, checkpoint.export_tables(dist, state.params['embedding']),
      checkpoint.get_optimizer_state(dist, state.opt_state[1]),
      extras=checkpoint.train_extras(dist, state, sparse=True), plan=dist)
  save_s = time.perf_counter() - t0
  size = os.path.getsize(path)
  verdict = verify_checkpoint.verify_one(path)
  model.init(0)
  _, fresh = build_trainer(model)
  t0 = time.perf_counter()
  restored, _ = checkpoint.restore_train_state(dist, fresh, path)
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  compare_digests(f'{tag} restore', want, logical_digests(dist, restored))
  bundle = quant_bundle(model, restored.params['embedding'], path, cats,
                        rng, tag)
  shutil.rmtree(CKPT_DIR / 'quant', ignore_errors=True)
  if verdict[0] != 'OK':
    raise AssertionError(f'{tag}: verify_checkpoint {verdict}')
  log(f'[{tag}] checkpoint: {size / 1e9:.2f} GB saved in {save_s:.2f} s, '
      f'restored in place in {restore_s:.2f} s, every table, accumulator, '
      f'MLP leaf and the step equal (audit digests); verify_checkpoint '
      f'{verdict[0]}: {verdict[1]}')
  return {'bytes': size, 'save_s': save_s, 'restore_s': restore_s,
          'bundle': bundle}


def quant_bundle(model, params, path, cats, rng, tag):
  """Phase 9g's serving bundle: the int8 checkpoint at ``path`` exported
  (``export_bundle_from_checkpoint`` with the model's configs), its
  members int8 payload and f32 scale with no optimizer member; an engine
  from the bundle alone (``from_bundle``, ``table_dtype='auto'``) serves
  int8, every lookup on the dequantizing arm (counted), and answers
  requests of ``REQUEST_SIZES`` samples equal to the model's lookup
  (``params``, the restored tables) bit-exact at hotness 1, 1e-6 at 10.
  The bundle is deleted with the checkpoint's directory."""
  dist = model.dist_embedding
  bundle = os.path.join(os.path.dirname(path), 'bundle.npz')
  t0 = time.perf_counter()
  summary = serving.export_bundle_from_checkpoint(
      path, bundle, table_configs=dist.table_configs)
  export_s = time.perf_counter() - t0
  arrays = checkpoint.read_manifest(bundle)['arrays']
  kinds = {k: v['dtype'] for k, v in arrays.items()}
  n_tables = len(dist.table_configs)
  payloads = [kinds.get(f'table{i}') for i in range(n_tables)]
  scales = [kinds.get(f'table{i}:scale') for i in range(n_tables)]
  if (summary['quantized'] != ['int8'] or set(payloads) != {'|i1'}
      or set(scales) != {'<f4'}
      or any(k.startswith('table') and '/' in k for k in arrays)):
    raise AssertionError(f'{tag}: bundle members {sorted(kinds.items())[:6]}'
                         f'..., summary {summary}')
  t0 = time.perf_counter()
  engine = ServingEngine.from_bundle(
      bundle, batch_size=SERVE_BATCH, device=dist.device,
      input_table_map=model.input_table_map, hotness=model.hotness)
  load_s = time.perf_counter() - t0
  if engine.stats()['table_dtype'] != 'int8':
    raise AssertionError(f'{tag}: the bundle engine serves '
                         f'{engine.stats()["table_dtype"]}, not int8')
  n_subs = len(engine.dist._subgroups(tuple(model.hotness)))
  engine.warmup(sample_cats=[c[:SERVE_BATCH] for c in cats])
  reset_launches()
  batch = np.asarray(cats[0]).shape[0]
  answers = []
  for n in REQUEST_SIZES:
    start = int(rng.integers(0, batch - n + 1))
    req = [c[start:start + n] for c in cats]
    answers.append((req, engine.lookup_padded(req)))
  torch.cuda.synchronize()
  launches = {'lookup_combine': lookup.LAUNCHES,
              'dequant': lookup.ARM_LAUNCHES['dequant'],
              'segwalk_apply': segwalk.LAUNCHES}
  want = len(REQUEST_SIZES) * n_subs
  if launches != {'lookup_combine': want, 'dequant': want,
                  'segwalk_apply': 0}:
    raise AssertionError(f'{tag}: the bundle engine launched {launches}, '
                         f'expected {want} dequantizing lookups')
  with torch.no_grad():
    for req, got in answers:
      ref = dist.apply(params, req)
      for i, (g, w, h) in enumerate(zip(got, ref, model.hotness)):
        same = (torch.equal(g, w) if h == 1 else
                torch.allclose(g, w, rtol=1e-6, atol=1e-6))
        if not same:
          raise AssertionError(f'{tag}: bundle engine, request of '
                               f'{len(req[0])}: input {i} differs from '
                               'the model lookup')
  size = os.path.getsize(bundle)
  del engine, answers
  gc.collect()
  torch.cuda.empty_cache()
  log(f'[{tag}] serving bundle: {n_tables} tables, int8 payload and f32 '
      f'scale members only ({size / 1e9:.3f} GB, '
      f'{summary["stripped_state_leaves"]} optimizer members stripped), '
      f'exported in {export_s:.2f} s; from_bundle (auto: int8) in '
      f'{load_s:.2f} s; requests of {list(REQUEST_SIZES)} samples equal '
      'the model lookup (bit-exact hotness 1, 1e-6 hotness 10), launches '
      f'{json.dumps(launches)}')
  return {'bytes': size, 'export_s': export_s, 'load_s': load_s,
          'launches': launches}


def run_quant_tiny(args):
  """Phase 9g: the tiny model in int8, then fp8 (see the module
  docstring).  Returns the numbers and the kernel rows of each dtype."""
  config = SYNTHETIC_MODELS[MODEL]
  rng = np.random.default_rng(args.seed + 31)
  (numerical, cats), _ = InputGenerator(config, BATCH, alpha=1.05,
                                        num_batches=1, seed=args.seed + 31)[0]
  tables, _, hotness = expand_tables(config)
  del tables
  cats = pad_multi_hot(cats, hotness, rng)
  out = {}
  for dtype in QUANT_DTYPES:
    out[dtype] = phase_quant_tiny(config, args.seed, dtype, numerical, cats,
                                  rng, ckpt=dtype == 'int8')
  return out


def run_dlrm_int8(seed):
  """Phase 13e: examples/dlrm/main.py --table_dtype int8 --param_dtype
  float32 at the uncut MLPerf vocabularies (see the module docstring).
  Returns its numbers and the captured lookup's row."""
  tag = 'dlrm-int8'
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = dlrm.DLRM(data.MLPERF_SIZES, embedding_dim=128,
                    param_dtype=torch.float32, compute_dtype=torch.float32,
                    dp_input=False, dist_strategy='memory_balanced',
                    table_dtype='int8', device='cuda').init(seed)
  torch.cuda.synchronize()
  dist = model.dist_embedding
  draw_s = time.perf_counter() - t0
  stats = quantization.table_bytes_stats(dist.plan)
  gib = quant_gib(model.embedding_params)
  log(f'[{tag}] {len(data.MLPERF_SIZES)} tables at the MLPerf Criteo-1TB '
      f'sizes, {stats["table_rows"]:,} rows x 128, int8 payloads and f32 '
      f'scales: {gib:.3f} GiB on the card ({stats["table_payload_bytes"] / 2**30:.3f}'
      f' GiB payload + {stats["table_scale_bytes"] / 2**30:.3f} GiB '
      f'scales; f32 would be {stats["table_payload_bytes"] * 4 / 2**30:.3f} '
      f'GiB), drawn and quantized in blocks on the card in {draw_s:.2f} s, '
      f'peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during the '
      'draw')
  batches = dlrm_batches(model, seed + 2, DLRM_INT8_STEPS + 3)
  cats, (numerical, _) = batches[0]
  reset_launches()
  with torch.no_grad():
    logits = model(numerical, cats)
  torch.cuda.synchronize()
  fwd = {'lookup_combine': lookup.LAUNCHES,
         'dequant': lookup.ARM_LAUNCHES['dequant']}
  if fwd != {'lookup_combine': 1, 'dequant': 1} or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f'{tag}: forward launched {fwd}, logits finite '
                         f'{bool(torch.isfinite(logits).all())}')
  (table, routed, combiner, scale), = captured_lookups(model, numerical,
                                                       cats)
  # the library call would dequantize the whole table first: 89.5 GiB
  row = check_dequant_shape(table, routed.reshape(-1, 1), scale,
                            f'dlrm_int8_w128_h1_ncap{routed.shape[0]}',
                            library=None)
  del table, routed, scale, logits
  step, state = dlrm_trainer(model)
  torch.cuda.reset_peak_memory_stats()
  state, loss = step(state, *batches[1])
  reset_launches()
  times, losses = [], []
  for batch in batches[2:DLRM_INT8_STEPS + 2]:
    t1 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t1) * 1e3)
    losses.append(float(loss))
  launches = {'lookup_combine': lookup.LAUNCHES,
              'dequant': lookup.ARM_LAUNCHES['dequant'],
              'segwalk_apply': segwalk.LAUNCHES}
  want = {'lookup_combine': DLRM_INT8_STEPS, 'dequant': DLRM_INT8_STEPS,
          'segwalk_apply': DLRM_INT8_STEPS}
  if launches != want or not all(np.isfinite(losses)):
    raise AssertionError(f'{tag}: steps launched {launches} (want {want}), '
                         f'losses {losses}')
  peak = torch.cuda.max_memory_allocated()
  syncs = host_syncs(lambda: step(state, *batches[DLRM_INT8_STEPS + 2]))
  med = statistics.median(times)
  log(f'[{tag}] the example\'s sparse trainer (SparseSGD(24), SGD on the '
      f'schedule): {DLRM_INT8_STEPS} steps, ms {[round(t, 3) for t in times]}'
      f' (host clock, synchronised), median {med:.3f} = '
      f'{BATCH / med * 1e3:,.0f} samples/s; losses {losses}; launches '
      f'{json.dumps(launches)}; peak {peak / 2**30:.3f} GiB; host syncs of '
      f'one more step {sum(syncs.values())}, by line '
      f'{json.dumps(dict(syncs.most_common()))}')
  numbers = {'table_gib': gib, 'draw_s': draw_s, 'forward': fwd,
             'launches': launches, 'step_ms': times, 'losses': losses,
             'peak_gib': peak / 2**30, 'host_syncs': sum(syncs.values())}
  del model, step, state
  gc.collect()
  torch.cuda.empty_cache()
  return numbers, row


def dequant_summary(quant_tiny, dlrm_int8):
  """The dequantizing arm's row of the kernels line: launches and times
  at the main path's shape (phase 13e's steps and captured lookup), each
  tiny model's shapes beside it."""
  numbers, row = dlrm_int8
  entry = dict(DEQUANT_ARM)
  tiny = {}
  errs = [row['max_abs_err']]
  for dtype, (n, rows) in quant_tiny.items():
    errs += [r['max_abs_err'] for r in rows]
    tiny[dtype] = {
        'launches': n['launches']['dequant'],
        'ms': sum(r['kernel_ms'] for r in rows),
        'plain_ms': sum(r['plain_ms'] for r in rows),
        'bound_ms': sum(r['bound_ms'] for r in rows),
        'library_ms': sum(r['library_ms'] for r in rows),
        'shapes': [{k: r[k] for k in ('shape', 'M', 'h', 'w', 'dtype',
                                      'distinct_rows', 'kernel_ms',
                                      'plain_ms', 'library_ms', 'bound_ms',
                                      'tolerance', 'max_abs_err')}
                   for r in rows],
        'numbers': n}
  entry.update({
      'launches': numbers['launches']['dequant'],
      'max_abs_err': max(errs),
      'ms': row['kernel_ms'], 'plain_ms': row['plain_ms'],
      'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
      'library_ms': None,
      'library_note': ('no PyTorch call takes an int8 table with per-row '
                       'scales; embedding_bag over the dequantized table '
                       'would make an 89.5 GiB f32 copy (the tiny models\' '
                       'library_ms time it, dequantization inside)'),
      'shape': {k: row[k] for k in ('M', 'h', 'w', 'dtype',
                                    'distinct_rows', 'bytes', 'tolerance')},
      'dlrm_int8': numbers,
      'quant_tiny': tiny,
  })
  return entry


# ------------------------------------------------- 9h: wire-ranks (item 9b)


def _drift(a, b):
  """``(max |a - b|, max |b|)`` of two tensors, in row blocks."""
  err, scale = 0.0, 0.0
  a2, b2 = a.reshape(a.shape[0] if a.dim() else 1, -1), b.reshape(
      b.shape[0] if b.dim() else 1, -1)
  for r0 in range(0, a2.shape[0], CHECK_BLOCK_ROWS):
    x = a2[r0:r0 + CHECK_BLOCK_ROWS].detach().float()
    y = b2[r0:r0 + CHECK_BLOCK_ROWS].detach().float()
    err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
    scale = max(scale, float(y.abs().max()) if y.numel() else 0.0)
  return err, scale


def check_wired(tag, got, want, exact):
  """Two lists of tensors of a wired arm and its twin: bit for bit
  (``exact``, the ``'table'`` wire) or within ``BF16_WIRE_BOUND`` of each
  tensor's scale (the bf16 wire).  Returns the largest relative drift."""
  if len(got) != len(want):
    raise AssertionError(f'{tag}: {len(got)} tensors against {len(want)}')
  worst = 0.0
  for i, (g, w) in enumerate(zip(got, want)):
    if g.shape != w.shape or g.dtype != w.dtype:
      raise AssertionError(f'{tag} {i}: {g.dtype}{tuple(g.shape)} against '
                           f'{w.dtype}{tuple(w.shape)}')
    if exact:
      if not torch.equal(quantization.bits(g), quantization.bits(w)):
        raise AssertionError(f'{tag} {i}: the wired arm differs from its '
                             'twin')
      continue
    err, scale = _drift(g, w)
    drift = err / max(scale, 1e-6)
    worst = max(worst, drift)
    if drift > BF16_WIRE_BOUND:
      raise AssertionError(f'{tag} {i}: drift {drift} above '
                           f'{BF16_WIRE_BOUND}')
  return worst


def _state_tensors(state):
  """The tensors of a hybrid state as a rank holds them, in a fixed
  order: the embedding params and sparse optimizer state by key, the
  dense params, the dense optimizer's leaves."""
  emb = state.params['embedding']
  out = [emb[k] for k in sorted(emb)]
  sparse_state = state.opt_state[1]
  out += [v for k in sorted(sparse_state)
          for _, v in sorted(sparse_state[k].items())]
  out += [state.params[k] for k in sorted(state.params) if k != 'embedding']
  return out + list(optim.tree_leaves(state.opt_state[0]))


def probe_collectives(device, rank, world, group=None):
  """Each collective the multi-rank paths call, once on ``device`` under
  the process group's backend, over ``group`` (default the world; this
  process is its ``rank`` of ``world``), checked: ``{name: None or the
  error}``.  Every process calls it for the same groups in one order
  (its barrier is the world's)."""
  out = {}
  base = torch.arange(4 * world, dtype=torch.float32, device=device)

  def a2a():
    send = base + 100 * rank
    recv = torch.empty_like(send)
    torch_dist.all_to_all_single(recv, send, group=group,
                                 async_op=True).wait()
    want = torch.cat([base[4 * rank:4 * rank + 4] + 100 * r
                      for r in range(world)])
    return torch.equal(recv, want)

  def gather():
    parts = [torch.empty(4, device=device) for _ in range(world)]
    torch_dist.all_gather(parts, base[:4] + rank, group=group,
                          async_op=True).wait()
    return all(torch.equal(p, base[:4] + r) for r, p in enumerate(parts))

  def reduce():
    x = base + rank
    torch_dist.all_reduce(x, group=group)
    return torch.equal(x, world * base + sum(range(world)))

  for name, fn in (('all_to_all_single', a2a), ('all_gather', gather),
                   ('all_reduce', reduce)):
    try:
      out[name] = None if fn() else 'wrong result'
    except Exception as e:  # recorded and reported by the parent
      out[name] = f'{type(e).__name__}: {e}'
  torch_dist.barrier()
  return out


def wire_lookup_rows(dist, params, cats, tag):
  """Every lookup launch of one forward of ``dist`` (the cold gathers'
  ``fused_group_lookup`` calls and the hot partials' ``dense_lookup``,
  each with its scale on a quantized layer), captured from the forward
  itself and held against its plain version (``check_kernel_shape``, or
  ``check_dequant_shape`` where a scale comes with the table); the
  capture's launches count towards no path."""
  calls = []
  fused, dense = lookup.fused_group_lookup, lookup.dense_lookup

  def record_fused(table, routed, combiners, compute_dtype, scale=None):
    calls.extend((table, r.reshape(-1, r.shape[-1]), c, scale)
                 for r, c in zip(routed, combiners))
    return fused(table, routed, combiners, compute_dtype, scale)

  def record_dense(table, ids, combiner, out_dtype=None, scale=None):
    calls.append((table, ids, combiner, scale))
    return dense(table, ids, combiner, out_dtype, scale)

  lookup.fused_group_lookup = record_fused
  lookup.dense_lookup = record_dense
  try:
    with torch.no_grad():
      dist.apply(params, cats)
  finally:
    lookup.fused_group_lookup = fused
    lookup.dense_lookup = dense
  if any(c not in (None, 'sum') for _, _, c, _ in calls):
    raise AssertionError(f'{tag}: the synthetic models combine with sum '
                         'only')
  rows = []
  for table, ids, _, scale in calls:
    label = (f'{tag}_w{table.shape[1]}_h{ids.shape[1]}_n{ids.shape[0]}_'
             f'rows{table.shape[0]}')
    rows.append(check_kernel_shape(table, ids, label) if scale is None else
                check_dequant_shape(table, ids, scale, label,
                                    library='compact'))
  return rows


def wire_segwalk_rows(step, state, cats, batch, tag):
  """Every segment-walk launch of one more hybrid step, captured from the
  step itself (``captured_hot_step``) and held against its plain
  version: each segment sum (the cold and hot gradients, a quantized
  group's apply) bit-exact (``check_add_stream``); each apply on compact
  copies of its touched rows, within rtol = atol = 1e-6 and equal to
  what the step wrote, the sampled untouched rows unchanged
  (``check_compact``), then timed at lr 0 on the real state, which is
  not used after it.  The capture's launches count towards no path."""
  state, loss, calls = captured_hot_step(step, state, cats, batch)
  if not bool(torch.isfinite(loss)):
    raise AssertionError(f'{tag}: capture step loss {float(loss)}')
  rows = []
  for seg, srows, num, row_index in calls['sums']:
    segs = segwalk.sort_stream(seg.to(torch.int32), num,
                               None if row_index is None
                               else row_index.to(torch.int32))
    rows.append(check_add_stream(
        segs, srows.float(), num, torch.float32,
        f'{tag}_add_rows{num}_w{srows.shape[1]}', tag))
  for call in calls['applies']:
    table, grads, acc, op = (call['table'], call['grads'], call['acc'],
                             call['op'])
    label = f'{tag}_{op}_w{table.shape[1]}_rows{table.shape[0]}'
    check_untouched(call, label)
    touched = call['touched'].long()
    err, tol = check_compact(call, op, grads, label, stepped=(
        table[touched], state_rows(acc, touched)))
    segs = segwalk.sort_stream(call['ids'], table.shape[0], call['g_index'])
    kernel_ms = device_ms(lambda: segwalk.apply_segments(
        table, acc, segs, grads, 0.0, op=op), 10)
    plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
        table, acc, segs, grads, 0.0, op=op))
    row, _ = stream_row(call, op, grads, acc, label, err, tol, kernel_ms,
                        plain_ms, None)
    log(f'[{tag}] ' + json.dumps(clocked(row)))
    rows.append(row)
  return rows


def checked_sum(rows):
  """The launches of a run held against their plain versions, their
  times and bounds summed (a null library time stays null)."""
  library = [r['library_ms'] for r in rows]
  return {'launches': len(rows),
          **{k: sum(r[k] for r in rows)
             for k in ('kernel_ms', 'plain_ms', 'bound_ms')},
          'library_ms': None if None in library else sum(library),
          'max_abs_err': max(r['max_abs_err'] for r in rows),
          'tolerances': sorted({r['tolerance'] for r in rows})}


def wire_rank(rank, init, out_dir, seed):
  """One of phase 9h's two ranks (a process of its own, both on the one
  card, joined over gloo): the collectives probed, then each arm of
  ``WIRE_ARMS`` beside its ``wire_dtype=None`` twin over the same tables
  (see the module docstring).  Writes ``rank{rank}.json`` under
  ``out_dir``."""
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import planner
  config = SYNTHETIC_MODELS[MODEL]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  world = WIRE_WORLD
  m = mesh_lib.init_distributed(init, world, rank, backend='gloo',
                                device='cuda:0')
  result = {'rank': rank, 'device': str(m.device), 'arms': {}}
  try:
    result['collectives'] = probe_collectives(m.device, rank, world)
    failed = {k: v for k, v in result['collectives'].items() if v}
    if failed:
      raise AssertionError(f'gloo on {m.device}: {failed}')
    tables, _, hotness = expand_tables(config)
    hotness = tuple(hotness)
    train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                      HOT_COVERAGE)
    local = BATCH // world
    lo, hi = rank * local, (rank + 1) * local

    def mine(b):
      cats, (numerical, labels) = b
      return ([c[lo:hi] for c in cats], (numerical[lo:hi], labels[lo:hi]))

    # the forwards', the warm-up's, the counted steps' and the capture
    # step's batches
    batches = [mine(b) for b in train_batches(
        config, hotness, seed + 41, WIRE_FORWARDS + WIRE_STEPS + 2)]
    # the steps run inside the rendezvous sanitizer's window: both ranks
    # walk the same exchanges and steps, so their digests must agree
    with commsan.capture('wire-ranks', timeout_s=COMMSAN_TIMEOUT_S) as cap:
      for wire, options in WIRE_ARMS:
        options = dict(options)
        if options.pop('hot_cache', False):
          options['hot_cache'] = train_sets
        exact = wire == 'table'
        models = {w: SyntheticModel(config, mesh=m, dp_input=True,
                                    wire_dtype=w, **options).init(seed + 43)
                  for w in (wire, None)}
        on, off = models[wire], models[None]
        check_wired(f'{wire}: the twins\' tables as drawn',
                    [on.embedding_params[k] for k in sorted(
                        on.embedding_params)],
                    [off.embedding_params[k] for k in sorted(
                        off.embedding_params)], exact=True)
        dist = on.dist_embedding
        n_subs = len(dist._subgroups(hotness))
        n_groups = len(dist.plan.groups)
        if dist.hot_enabled:
          fwd_want, step_want = hot_launches(dist, hotness)
        else:
          fwd_want = {'lookup_combine': chunk_rounds(dist, hotness),
                      'segwalk_apply': 0}
          step_want = {'lookup_combine': fwd_want['lookup_combine'],
                       'segwalk_apply': n_groups}
        arm = {'options': {k: (v if k != 'hot_cache' else len(v))
                           for k, v in options.items()},
               'subgroups': n_subs, 'groups': n_groups}
        # forwards: the wired arm counted, each against its twin
        drift, fwd_ms = 0.0, []
        for cats, _ in batches[:WIRE_FORWARDS]:
          with torch.no_grad():
            reset_launches()
            t0 = time.perf_counter()
            got = dist.apply(on.embedding_params, cats)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_launches()
            want = off.dist_embedding.apply(off.embedding_params, cats)
          if launches != fwd_want:
            raise AssertionError(f'{wire}: the wired forward launched '
                                 f'{launches}, expected {fwd_want}')
          drift = max(drift, check_wired(f'{wire} forward', list(got),
                                         list(want), exact))
        arm['forward'] = {'launches': launches, 'ms': fwd_ms, 'drift': drift}
        # each lookup launch of a wired forward against its plain version
        tag = f'wire-rank{rank}-{wire}'
        lookup_rows = wire_lookup_rows(dist, on.embedding_params,
                                       batches[0][0], tag)
        if len(lookup_rows) != fwd_want['lookup_combine']:
          raise AssertionError(f'{tag}: {len(lookup_rows)} lookups captured, '
                               f'{fwd_want["lookup_combine"]} launched')
        # the recorded legs: narrowed, at the twin's collective count
        lp_on, lp_off = dist.lookup_plan(), off.dist_embedding.lookup_plan()
        wired = [l for l in lp_on.legs if l.wire]
        if (not wired or [l for l in lp_off.legs if l.wire]
            or lp_on.collective_count() != lp_off.collective_count()
            or any(l.nbytes >= l.payload_bytes for l in wired)
            or any(l.dtype != ('uint8' if l.wire == 'q8' else 'bfloat16')
                   for l in wired)):
          raise AssertionError(
              f'{wire}: legs {[(l.name, l.dtype, l.wire) for l in lp_on.legs]}'
              f' ({lp_on.collective_count()} collectives against the '
              f'twin\'s {lp_off.collective_count()})')
        rec = planner.reconcile_exchange(dist, journal=False)
        arm['legs'] = {'collectives': lp_on.collective_count(),
                       'wired': sorted({l.name for l in wired}),
                       'wire_bytes': rec['counted_wire_bytes'],
                       'payload_bytes': rec['counted_payload_bytes']}
        arm['line'] = (
            f'wire_dtype {wire}: narrowed leg(s) {arm["legs"]["wired"]}; '
            f'forward exchange ships {rec["counted_wire_bytes"]:,} bytes on '
            f'the wire vs {rec["counted_payload_bytes"]:,} at compute dtype '
            f'({rec["counted_payload_bytes"] / max(rec["counted_wire_bytes"], 1):.2f}x '
            'fewer)')
        # a warm-up and `steps` hybrid steps each, phase 7's optimizers
        trainers = {w: build_trainer(models[w]) for w in (wire, None)}
        losses, step_ms, counted = {wire: [], None: []}, [], None
        for w in (wire, None):
          step, state = trainers[w]
          state, loss = step(state, *batches[WIRE_FORWARDS])
          losses[w].append(float(loss))
          reset_launches()
          for b in batches[WIRE_FORWARDS + 1:-1]:
            t0 = time.perf_counter()
            state, loss = step(state, *b)
            torch.cuda.synchronize()
            if w == wire:
              step_ms.append((time.perf_counter() - t0) * 1e3)
            losses[w].append(float(loss))
          if w == wire:
            counted = read_launches()
          trainers[w] = (step, state)
        want_steps = {k: v * WIRE_STEPS for k, v in step_want.items()}
        if counted != want_steps:
          raise AssertionError(f'{wire}: the wired steps launched {counted}, '
                               f'expected {want_steps}')
        if not all(np.isfinite(losses[wire] + losses[None])):
          raise AssertionError(f'{wire}: losses {losses}')
        arm['steps'] = {
            'launches': counted, 'ms': step_ms, 'losses': losses[wire],
            'twin_losses': losses[None],
            'drift': check_wired(f'{wire} state after the steps',
                                 _state_tensors(trainers[wire][1]),
                                 _state_tensors(trainers[None][1]), exact)}
        # each segment-walk launch of one more wired step against its plain
        # version
        seg_rows = wire_segwalk_rows(*trainers[wire], *batches[-1], tag)
        if len(seg_rows) != step_want['segwalk_apply']:
          raise AssertionError(f'{tag}: {len(seg_rows)} segment walks '
                               f'captured, {step_want["segwalk_apply"]} '
                               'launched a step')
        arm['kernels'] = {'lookup_combine': lookup_rows,
                          'segwalk_apply': seg_rows}
        result['arms'][wire] = arm
        del models, on, off, dist, trainers, got, want
        gc.collect()
        torch.cuda.empty_cache()
      cap.barrier_check('wire-ranks:end')
    digest, count = cap.digest()
    result['commsan'] = {'digest': digest, 'records': count,
                         'checks': cap.checks}
    torch_dist.barrier()
  finally:
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
      json.dump(result, f)
    torch_dist.destroy_process_group()
  return result


def rank_main(fn_name, rank, init, out_dir, *args):
  """The body of a rank process of phases 9h and 9i: ``faulthandler`` on,
  ``fn_name(rank, init, out_dir, *args)`` run (its ``finally`` tears its
  process group down), the streams flushed, ``done{rank}`` written under
  ``out_dir``, and then ``os._exit(0)``: the interpreter's teardown (the
  module and C++ static destructors) is skipped, where a gloo rank could
  abort with ``terminate called without an active exception`` after its
  work was done.  A rank that raised exits non-zero without its marker."""
  import faulthandler
  faulthandler.enable(all_threads=True)
  globals()[fn_name](rank, init, out_dir, *args)
  sys.stdout.flush()
  sys.stderr.flush()
  with open(os.path.join(out_dir, f'done{rank}'), 'w') as f:
    f.write('done\n')
  os._exit(0)


def launch_ranks(tag, root, fn_name, world, timeout_s, *args):
  """``world`` processes on the one card running ``rank_main(fn_name,
  rank, ...)``, joined through a file rendezvous under ``root`` (no port
  to race for, no TCPStore thread), each writing its output to
  ``root/rank{r}.log``.  Fails unless every rank exits 0 within
  ``timeout_s`` and left its marker; the message gives each rank's exit
  code (-6 is SIGABRT), its marker and the tail of its output.  Returns
  the wall seconds."""
  here = str(pathlib.Path(__file__).resolve().parent)
  init = f'file://{root / "rendezvous"}'
  procs, logs = [], []
  t0 = time.perf_counter()
  for rank in range(world):
    logs.append(open(root / f'rank{rank}.log', 'w+'))
    code = (f'import sys; sys.path.insert(0, {here!r}); import chip_smoke; '
            f'chip_smoke.rank_main({fn_name!r}, {rank}, {init!r}, '
            f'{str(root)!r}, *{args!r})')
    procs.append(subprocess.Popen([sys.executable, '-c', code], cwd=here,
                                  stdout=logs[-1], stderr=subprocess.STDOUT))
  deadline = time.monotonic() + timeout_s
  hung = False
  for p in procs:
    try:
      p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
      hung = True
  for p in procs:
    if p.poll() is None:
      p.kill()
      p.wait()
  wall = time.perf_counter() - t0
  outputs = []
  for f in logs:
    f.seek(0)
    outputs.append(f.read())
    f.close()
  codes = [p.returncode for p in procs]
  markers = [(root / f'done{r}').exists() for r in range(world)]
  if hung or any(codes) or not all(markers):
    for rank, text in enumerate(outputs):
      log(f'[{tag}] rank {rank} (exit {codes[rank]}, marker '
          f'{"written" if markers[rank] else "missing"}) output:\n'
          + text[-20000:])
    raise AssertionError(f'{tag}: {"a rank hung past " if hung else ""}'
                         f'{timeout_s if hung else ""} exit codes {codes}, '
                         f'markers {markers}')
  return wall


def phase_wire_ranks(seed):
  """Phase 9h: two processes on the one card, joined over gloo, run
  ``wire_rank`` (see the module docstring) through ``launch_ranks``.  A
  child that fails or does not end within ``WIRE_TIMEOUT_S`` fails the
  phase, its output printed.  Returns the numbers of both ranks."""
  root = CKPT_DIR.parent / 'chip_smoke_wire'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  wall = launch_ranks('wire-ranks', root, 'wire_rank', WIRE_WORLD,
                      WIRE_TIMEOUT_S, seed)
  results = []
  for rank in range(WIRE_WORLD):
    with open(root / f'rank{rank}.json') as f:
      results.append(json.load(f))
  shutil.rmtree(root)
  for r in results:
    log(f'[wire-ranks] rank {r["rank"]} on {r["device"]}: gloo took CUDA '
        f'tensors in {sorted(r["collectives"])}')
    log(f'[wire-ranks] rank {r["rank"]} commsan: digest '
        f'{r["commsan"]["digest"]} over {r["commsan"]["records"]} records, '
        f'{r["commsan"]["checks"]} barrier check(s)')
    for wire, arm in r['arms'].items():
      log(f'[wire-ranks] rank {r["rank"]} {arm["line"]}')
      log(f'[wire-ranks] rank {r["rank"]} {wire} ({json.dumps(arm["options"])}'
          f'): forwards {json.dumps(arm["forward"])}; steps (gloo through '
          f'the host, host clock, synchronised) {json.dumps(arm["steps"])}')
      log(f'[wire-ranks] rank {r["rank"]} {wire}: every launch of a wired '
          'forward and of one more wired step held against its plain '
          'version (device_ms, queued, while the other rank shares the '
          'card): ' + json.dumps(clocked(
              {name: checked_sum(rows)
               for name, rows in arm['kernels'].items()})))
  digests = {(r['commsan']['digest'], r['commsan']['records'])
             for r in results}
  if len(digests) != 1:
    raise AssertionError(f'wire-ranks: the ranks\' commsan digests differ: '
                         f'{[r["commsan"] for r in results]}')
  log(f'[wire-ranks] both ranks passed in {wall:.1f} s (two processes on '
      'one card over gloo, which stages CUDA tensors through host memory: '
      'a correctness run, not an exchange speed)')
  return {'wall_s': wall, 'ranks': results}


def wire_summary(k, seg, wire_ranks):
  """Phase 9h in the kernels line: per kernel, each arm's step launches
  on each rank (``launches_wire_ranks``) and each rank's launches held
  against their plain versions, summed (``wire_ranks``); their largest
  error joins the kernel's ``max_abs_err``."""
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    rows = {wire: [r['arms'][wire]['kernels'][name]
                   for r in wire_ranks['ranks']] for wire, _ in WIRE_ARMS}
    entry['launches_wire_ranks'] = {
        wire: [r['arms'][wire]['steps']['launches'][name]
               for r in wire_ranks['ranks']] for wire, _ in WIRE_ARMS}
    entry['wire_ranks'] = {wire: [checked_sum(rank) for rank in ranks]
                           for wire, ranks in rows.items()}
    entry['max_abs_err'] = max([entry['max_abs_err']] + [
        r['max_abs_err'] for ranks in rows.values() for rank in ranks
        for r in rank])


# ---------------------------------------------------- 9i: dcn-ranks


def hier_rows(tag, hdist, got, want):
  """Two ``{leaf: tensor}`` dicts of a ``dcn_sharding`` layer's params on
  this rank, equal bit for bit on every REAL row of each table leaf (the
  cell's ``rows_h``; padding past them is filler) and in full on the hot
  buffers."""
  real = {gi: g.rows_h[hdist.slice_index][hdist.rank]
          for gi, g in enumerate(hdist.hier.groups)}
  if sorted(got) != sorted(want):
    raise AssertionError(f'{tag}: leaves {sorted(got)} against '
                         f'{sorted(want)}')
  for k in sorted(got):
    a, b = got[k], want[k]
    if not k.startswith('hot_'):
      n = real[int(k.rsplit('_', 1)[1])]
      a, b = a[:n], b[:n]
    if not torch.equal(quantization.bits(a), quantization.bits(b)):
      raise AssertionError(f'{tag}: {k} differs')


def hier_state(hdist, flat_state):
  """A flat twin's sparse optimizer state in the hierarchical layout of
  ``hdist`` (this cell's sub-windows of each group's rows, as
  ``hierarchical_params`` relocates the tables)."""
  s, d = hdist.slice_index, hdist.rank
  out = {}
  for k, leaves in flat_state.items():
    if k.startswith('hot_'):
      out[k] = leaves
      continue
    hl = hdist.hier.groups[int(k.rsplit('_', 1)[1])]
    out[k] = {leaf: torch.cat([v[lo:lo + n] for lo, n in
                               hl.flat_ranges[s][d]])
              for leaf, v in leaves.items()}
  return out


def dcn_rank(rank, init, out_dir, seed):
  """One of phase 9i's four ranks (a process of its own, all on the one
  card, a 2 x 2 ``(dcn, data)`` mesh over gloo): each group's
  collectives probed, then each arm of ``DCN_ARMS`` as a
  ``dcn_sharding=True`` model beside its two-axis flat twin drawn from
  the same seed (see the module docstring).  Writes ``rank{rank}.json``
  under ``out_dir``."""
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      hierarchical_params)
  config = SYNTHETIC_MODELS[MODEL]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  world = DCN_SHAPE[0] * DCN_SHAPE[1]
  m = mesh_lib.init_distributed(init, world, rank, backend='gloo',
                                device='cuda:0', mesh_shape=DCN_SHAPE)
  result = {'rank': rank, 'cell': [m.slice_index, m.rank],
            'device': str(m.device), 'arms': {}}
  try:
    result['collectives'] = {
        axis: probe_collectives(m.device, idx, n, group)
        for axis, idx, n, group in (
            ('data', m.rank, m.world_size, m.group),
            ('dcn', m.slice_index, m.num_slices, m.dcn_group),
            ('product', m.product_rank, m.product_size, m.product_group))}
    failed = {a: {k: v for k, v in c.items() if v}
              for a, c in result['collectives'].items()}
    if any(failed.values()):
      raise AssertionError(f'gloo on {m.device}: {failed}')
    tables, _, hotness = expand_tables(config)
    hotness = tuple(hotness)
    train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                      HOT_COVERAGE)
    local = BATCH // world
    lo, hi = m.product_rank * local, (m.product_rank + 1) * local

    def mine(b):
      cats, (numerical, labels) = b
      return ([c[lo:hi] for c in cats], (numerical[lo:hi], labels[lo:hi]))

    # the forwards', the warm-up's, the counted steps' and the capture
    # step's batches (global; each rank takes its block)
    global_batches = train_batches(config, hotness, seed + 47,
                                   DCN_FORWARDS + DCN_STEPS + 2)
    batches = [mine(b) for b in global_batches]
    for name, options in DCN_ARMS:
      options = dict(options)
      if options.pop('hot_cache', False):
        options['hot_cache'] = train_sets
      models = {h: SyntheticModel(config, mesh=m, dp_input=True,
                                  dcn_sharding=h, **options).init(seed + 43)
                for h in (True, False)}
      hier, flat = models[True], models[False]
      hdist, fdist = hier.dist_embedding, flat.dist_embedding
      # the hierarchical draw is the twin's resharded
      hier_rows(f'{name}: init', hdist, hier.embedding_params,
                hierarchical_params(hdist, flat.embedding_params))
      check_equal(f'{name}: MLP', list(hier.dense_params().values()),
                  list(flat.dense_params().values()))
      rounds = chunk_rounds(fdist, hotness)
      arm = {'options': {k: (v if k != 'hot_cache' else len(v))
                         for k, v in options.items()},
             'subgroups': len(hdist._subgroups(hotness)),
             'groups': len(hdist.plan.groups), 'chunk_rounds': rounds,
             'hier_rows_cap': [g.rows_cap_h for g in hdist.hier.groups],
             'flat_rows_cap': [g.rows_cap for g in fdist.plan.groups]}
      # forwards: the hierarchical one counted, each bit-equal to the
      # twin's; the DCN pair adds a gather and a combine a subgroup and
      # round to the twin's lookups
      fwd_ms = []
      for cats, _ in batches[:DCN_FORWARDS]:
        with torch.no_grad():
          reset_launches()
          want = fdist.apply(flat.embedding_params, cats)
          torch.cuda.synchronize()
          twin = read_launches()
          reset_launches()
          t0 = time.perf_counter()
          got = hdist.apply(hier.embedding_params, cats)
          torch.cuda.synchronize()
          fwd_ms.append((time.perf_counter() - t0) * 1e3)
          launches = read_launches()
        check_equal(f'{name} forward', list(got), list(want))
        if (launches['lookup_combine'] != twin['lookup_combine'] + rounds
            or launches['segwalk_apply'] or not twin['lookup_combine']):
          raise AssertionError(f'{name}: the forward launched {launches}, '
                               f'the twin {twin}, {rounds} subgroup rounds')
      arm['forward'] = {'launches': launches, 'twin_launches': twin,
                        'ms': fwd_ms}
      tag = f'dcn-rank{rank}-{name}'
      lookup_rows = wire_lookup_rows(hdist, hier.embedding_params,
                                     batches[0][0], tag)
      if len(lookup_rows) != launches['lookup_combine']:
        raise AssertionError(f'{tag}: {len(lookup_rows)} lookups captured, '
                             f'{launches["lookup_combine"]} launched')
      # the recorded legs: the DCN pair on the dcn axis; the table wire
      # ships dcn/rows as the stored payload (uint8)
      legs = hdist.lookup_plan().legs
      dcn_legs = [l for l in legs if l.name.startswith('dcn/')]
      if (sorted({l.name.split('/')[0] + '/' + l.name.split('/')[1]
                  for l in dcn_legs}) != ['dcn/ids', 'dcn/rows']
          or any(l.axis != 'dcn' for l in dcn_legs)):
        raise AssertionError(f'{name}: legs {[(l.name, l.axis) for l in legs]}')
      rows_legs = [l for l in dcn_legs if l.name.startswith('dcn/rows')]
      if options.get('wire_dtype') == 'table' and any(
          l.dtype != 'uint8' or l.wire != 'q8' for l in rows_legs):
        raise AssertionError(f'{name}: dcn/rows legs '
                             f'{[(l.dtype, l.wire) for l in rows_legs]}')
      arm['legs'] = {'collectives': len(legs),
                     'dcn': [(l.name, l.dtype, l.wire, l.nbytes)
                             for l in dcn_legs]}
      if m.product_rank == 0:
        counters = hotcache.measure_exchange_counters(
            hdist, global_batches[0][0])
        arm['counters'] = {k: counters[k] for k in (
            'dcn_rows', 'dcn_rows_off', 'dcn_dedup_ratio',
            'dcn_rows_per_slice', 'dcn_rows_off_per_slice', 'ici_rows')}
        if not (0 < counters['dcn_rows'] < counters['dcn_rows_off']
                and counters['dcn_dedup_ratio'] > 1.0):
          raise AssertionError(f'{name}: counters {arm["counters"]}')
      # a warm-up and DCN_STEPS hybrid steps each way, phase 7's
      # optimizers: every loss and every real row bit-equal
      trainers = {h: build_trainer(models[h]) for h in (True, False)}
      losses, step_ms, counted = {True: [], False: []}, [], {}
      for h in (True, False):
        step, state = trainers[h]
        state, loss = step(state, *batches[DCN_FORWARDS])
        losses[h].append(float(loss))
        reset_launches()
        for b in batches[DCN_FORWARDS + 1:-1]:
          t0 = time.perf_counter()
          state, loss = step(state, *b)
          torch.cuda.synchronize()
          if h:
            step_ms.append((time.perf_counter() - t0) * 1e3)
          losses[h].append(float(loss))
        counted[h] = read_launches()
        trainers[h] = (step, state)
      if losses[True] != losses[False] or not all(np.isfinite(losses[True])):
        raise AssertionError(f'{name}: losses {losses}')
      want_launches = dict(counted[False])
      want_launches['lookup_combine'] += rounds * DCN_STEPS
      if counted[True] != want_launches or not counted[True][
          'segwalk_apply']:
        raise AssertionError(f'{name}: the steps launched {counted[True]}, '
                             f'the twin {counted[False]}')
      hstate, fstate = trainers[True][1], trainers[False][1]
      hier_rows(f'{name}: tables after the steps', hdist,
                hstate.params['embedding'],
                hierarchical_params(hdist, fstate.params['embedding']))
      want_opt = hier_state(hdist, fstate.opt_state[1])
      for k, leaves in hstate.opt_state[1].items():
        for leaf, v in leaves.items():
          hier_rows(f'{name}: optimizer state {k}/{leaf} after the steps',
                    hdist, {k: v}, {k: want_opt[k][leaf]})
      check_equal(f'{name}: MLP and its optimizer after the steps',
                  [hstate.params[k] for k in sorted(hstate.params)
                   if k != 'embedding']
                  + list(optim.tree_leaves(hstate.opt_state[0])),
                  [fstate.params[k] for k in sorted(fstate.params)
                   if k != 'embedding']
                  + list(optim.tree_leaves(fstate.opt_state[0])))
      arm['steps'] = {'launches': counted[True],
                      'twin_launches': counted[False], 'ms': step_ms,
                      'losses': losses[True]}
      # each segment-walk launch of one more hierarchical step against its
      # plain version
      per_step = {k: v // DCN_STEPS for k, v in counted[True].items()}
      seg_rows = wire_segwalk_rows(*trainers[True], *batches[-1], tag)
      if len(seg_rows) != per_step['segwalk_apply']:
        raise AssertionError(f'{tag}: {len(seg_rows)} segment walks '
                             f'captured, {per_step["segwalk_apply"]} '
                             'launched a step')
      arm['kernels'] = {'lookup_combine': lookup_rows,
                        'segwalk_apply': seg_rows}
      arm['line'] = (
          f'{name}: hierarchical forward, steps and rows bit-equal to the '
          f'two-axis flat twin; DCN legs '
          f'{[(l.name, l.dtype) for l in dcn_legs]}' + (
              f'; counters dcn_rows {arm["counters"]["dcn_rows"]:,}, '
              f'dcn_rows_off {arm["counters"]["dcn_rows_off"]:,}, ratio '
              f'{arm["counters"]["dcn_dedup_ratio"]}'
              if 'counters' in arm else ''))
      result['arms'][name] = arm
      del models, hier, flat, hdist, fdist, trainers, hstate, fstate, got
      del want, want_opt
      gc.collect()
      torch.cuda.empty_cache()
    torch_dist.barrier()
  finally:
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
      json.dump(result, f)
    torch_dist.destroy_process_group()
  return result


def phase_dcn_ranks(seed):
  """Phase 9i: four processes on the one card, a 2 x 2 ``(dcn, data)``
  mesh over gloo, run ``dcn_rank`` (see the module docstring) through
  ``launch_ranks``.  A rank that fails or does not end within
  ``DCN_TIMEOUT_S`` fails the phase, its output printed.  Returns the
  numbers of every rank."""
  root = CKPT_DIR.parent / 'chip_smoke_dcn'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  world = DCN_SHAPE[0] * DCN_SHAPE[1]
  wall = launch_ranks('dcn-ranks', root, 'dcn_rank', world, DCN_TIMEOUT_S,
                      seed)
  results = []
  for rank in range(world):
    with open(root / f'rank{rank}.json') as f:
      results.append(json.load(f))
  shutil.rmtree(root)
  for r in results:
    log(f'[dcn-ranks] rank {r["rank"]} (slice, data) {r["cell"]} on '
        f'{r["device"]}: gloo took CUDA tensors in '
        f'{ {a: sorted(c) for a, c in r["collectives"].items()} }')
    for name, arm in r['arms'].items():
      log(f'[dcn-ranks] rank {r["rank"]} {arm["line"]}')
      log(f'[dcn-ranks] rank {r["rank"]} {name} '
          f'({json.dumps(arm["options"])}): forwards '
          f'{json.dumps(arm["forward"])}; steps (gloo through the host, '
          f'host clock, synchronised) {json.dumps(arm["steps"])}; legs '
          f'{json.dumps(arm["legs"])}'
          + (f'; counters {json.dumps(arm["counters"])}'
             if 'counters' in arm else ''))
      log(f'[dcn-ranks] rank {r["rank"]} {name}: every launch of a '
          'hierarchical forward and of one more step held against its '
          'plain version (device_ms, queued, while three other ranks share '
          'the card): ' + json.dumps(clocked(
              {k: checked_sum(rows) for k, rows in arm['kernels'].items()})))
  log(f'[dcn-ranks] all four ranks passed in {wall:.1f} s (four processes '
      'on one card over gloo, which stages CUDA tensors through host '
      'memory: a correctness run, not an exchange speed)')
  return {'wall_s': wall, 'ranks': results}


def dcn_summary(k, seg, dcn_ranks):
  """Phase 9i in the kernels line: per kernel, each arm's step launches
  on each rank (``launches_dcn_ranks``) and each rank's launches held
  against their plain versions, summed (``dcn_ranks``); their largest
  error joins the kernel's ``max_abs_err``."""
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    rows = {arm: [r['arms'][arm]['kernels'][name]
                  for r in dcn_ranks['ranks']] for arm, _ in DCN_ARMS}
    entry['launches_dcn_ranks'] = {
        arm: [r['arms'][arm]['steps']['launches'][name]
              for r in dcn_ranks['ranks']] for arm, _ in DCN_ARMS}
    entry['dcn_ranks'] = {arm: [checked_sum(rank) for rank in ranks]
                          for arm, ranks in rows.items()}
    entry['max_abs_err'] = max([entry['max_abs_err']] + [
        r['max_abs_err'] for ranks in rows.values() for rank in ranks
        for r in rank])


# ---------------------------------------------------- 13f: dlrm-wire


def codec_timings(rows):
  """The wire codec on the card over f32 ``rows``: per dtype, on the
  grid rows quantizing them gives, the card's encode equal to the numpy
  encoder's bytes on the host copy and decode then encode the identity,
  both timed beside their bound; the bf16 cast of ``rows`` equal to the
  CPU's, timed."""
  n, w = rows.shape
  out = {'rows': n, 'width': w}
  for name in QUANT_DTYPES:
    spec = quantization.resolve_table_dtype(name)
    grid = quantization.dequantize(*quantization.quantize(rows, spec))
    enc = quantization.wire_encode_rows(grid, spec)
    host = quantization.wire_encode_rows_np(grid.cpu().numpy(), spec)
    if not np.array_equal(enc.cpu().numpy(), host):
      raise AssertionError(f'dlrm-wire {name}: the card\'s encode differs '
                           'from the numpy encoder')
    dec = quantization.wire_decode_rows(enc, spec, w)
    if not torch.equal(dec, grid):
      raise AssertionError(f'dlrm-wire {name}: decode(encode(rows)) is not '
                           'the identity on grid rows')
    f32_bytes = grid.numel() * 4
    wire_bytes = enc.numel()
    bound = (f32_bytes + wire_bytes) / HBM_BYTES_PER_S * 1e3
    out[name] = {
        'wire_bytes_per_row': quantization.wire_bytes_per_row(w, spec),
        'encode_ms': device_ms(
            lambda: quantization.wire_encode_rows(grid, spec), 10,
            floor_ms=bound),
        'decode_ms': device_ms(
            lambda: quantization.wire_decode_rows(enc, spec, w), 10,
            floor_ms=bound),
        'bound_ms': bound, 'bound_by': 'bytes'}
    del grid, enc, host, dec
  cast = rows.to(torch.bfloat16)
  if not torch.equal(cast.cpu(), rows.cpu().to(torch.bfloat16)):
    raise AssertionError('dlrm-wire: the card\'s bf16 cast differs from the '
                         'CPU\'s')
  bound = rows.numel() * 6 / HBM_BYTES_PER_S * 1e3
  out['bfloat16'] = {
      'cast_ms': device_ms(lambda: rows.to(torch.bfloat16), 10,
                           floor_ms=bound),
      'bound_ms': bound, 'bound_by': 'bytes'}
  return out


def phase_dlrm_wire(seed):
  """Phase 13f: ``examples/dlrm/main.py --dp_input --wire_dtype
  bfloat16`` and the same run without the flag in process at phase
  13b's onechip vocabularies, ``WIRE_EXAMPLE_STEPS`` steps and
  ``--save_state`` each: a world of one ships nothing, so the files list
  the same sha256 for every array; ``--wire_dtype table --table_dtype
  int8 --param_dtype float32`` is accepted and narrows no leg; then the
  codec at the DLRM's row count (``codec_timings``).  Returns the
  launches and numbers."""
  sizes = [min(s, ONECHIP_MAX_ROWS) for s in data.MLPERF_SIZES]
  check_disk(1.2 * sum(sizes) * 128 * 4, 'dlrm-wire')
  root = CKPT_DIR / 'dlrm_wire'
  shutil.rmtree(root, ignore_errors=True)
  root.mkdir(parents=True)
  common = ['--param_dtype', 'bfloat16', '--table_sizes',
            ','.join(map(str, sizes)), '--num_batches',
            str(WIRE_EXAMPLE_STEPS), '--max_steps', str(WIRE_EXAMPLE_STEPS),
            '--device', 'cuda', '--dp_input']
  out, manifests, launches = {}, {}, {}
  want = {'lookup_combine': WIRE_EXAMPLE_STEPS,
          'segwalk_apply': WIRE_EXAMPLE_STEPS}
  for wire in ('bfloat16', 'none'):
    gc.collect()
    torch.cuda.empty_cache()
    path = root / f'{wire}.npz'
    lines = _Tee()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(lines):
      res = dlrm_main.main(common + ['--wire_dtype', wire, '--save_state',
                                     str(path)])
    wall = time.perf_counter() - t0
    launches[wire] = read_launches()
    said = [l for l in lines.lines if l.startswith('wire_dtype ')]
    if (launches[wire] != want or res['step'] != WIRE_EXAMPLE_STEPS
        or (wire != 'none') != bool(said)):
      raise AssertionError(f'dlrm-wire --wire_dtype {wire}: launched '
                           f'{launches[wire]} (expected {want}), step '
                           f'{res["step"]}, wire line {said}')
    manifests[wire] = checkpoint.read_manifest(str(path))['arrays']
    os.remove(path)
    out[wire] = {'launches': launches[wire], 'wall_s': wall,
                 'loss': res['loss'], 'save_s': res['save_s'],
                 'line': said[0] if said else None}
  if manifests['bfloat16'] != manifests['none']:
    bad = [k for k in manifests['none']
           if manifests['none'][k] != manifests['bfloat16'].get(k)]
    raise AssertionError(f'dlrm-wire: the --wire_dtype bfloat16 file '
                         f'differs from the unwired one in {bad}')
  shutil.rmtree(root)
  gc.collect()
  torch.cuda.empty_cache()
  lines = _Tee()
  with contextlib.redirect_stdout(lines):
    res = dlrm_main.main(common[:-1] + [
        '--param_dtype', 'float32', '--table_dtype', 'int8', '--wire_dtype',
        'table', '--max_steps', '1'])
  said = [l for l in lines.lines if l.startswith('wire_dtype table: ')]
  if not said or 'narrowed leg(s) none' not in said[0] or res['step'] != 1:
    raise AssertionError(f'dlrm-wire --wire_dtype table: {said}, step '
                         f'{res["step"]}')
  out['table'] = {'line': said[0], 'loss': res['loss']}
  log(f'[dlrm-wire] the example with --dp_input --wire_dtype bfloat16 and '
      f'without it, {WIRE_EXAMPLE_STEPS} steps each ({sum(sizes):,} rows, '
      f'the onechip cut): the files list the same sha256 for all '
      f'{len(manifests["none"])} arrays (a world of one ships nothing); '
      f'--wire_dtype table --table_dtype int8 accepted: {said[0]}; '
      f'{json.dumps(out)}')
  del res
  gc.collect()
  torch.cuda.empty_cache()
  gen = torch.Generator(device='cuda').manual_seed(seed + 47)
  rows = torch.randn((DLRM_WIRE_ROWS, 128), generator=gen, device='cuda')
  codec = codec_timings(rows)
  del rows
  gc.collect()
  torch.cuda.empty_cache()
  log(f'[dlrm-wire] the codec at the DLRM\'s {DLRM_WIRE_ROWS:,} rows x 128 '
      f'(torch ops, not a kernel; device_ms, queued): the card\'s encode '
      f'equals the numpy encoder\'s bytes and decode(encode) is the '
      f'identity on grid rows, int8 and fp8; the bf16 cast equals the '
      f'CPU\'s; {json.dumps(clocked(codec))}')
  out['codec'] = codec
  return launches['bfloat16'], out


# ------------------------------------------------------ host-DRAM cold tier


def same_bits(a, b):
  """Two tensors equal bit for bit (a ``-0.0`` against a ``+0.0`` or two
  NaNs of other payloads differ): compared through an integer view of
  their bytes, in row blocks."""
  if a.shape != b.shape or a.dtype != b.dtype:
    return False
  ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
  view = lambda x: x.contiguous().view(ints[x.element_size()])
  for r0 in range(0, max(1, a.shape[0]), CHECK_BLOCK_ROWS):
    x = a[r0:r0 + CHECK_BLOCK_ROWS]
    y = b[r0:r0 + CHECK_BLOCK_ROWS].to(x.device)
    if not torch.equal(view(x), view(y)):
      return False
  return True


def tier_tail(tier, gi, what, leaf=None):
  """A host tail of the tier as a CPU tensor of its dtype."""
  if what == 'opt':
    return tier.opt_tail(gi, leaf)
  arr = tier.payload[gi] if what == 'payload' else tier.scale[gi]
  t = torch.from_numpy(arr)
  if what == 'payload' and tier.quant is not None:
    t = t.view(tier.quant.torch_dtype)
  return t


def check_tier_state(tag, tdist, tparams, tstate, udist, uparams, ustate):
  """A tiered layer's state against its fully resident twin's, bit for
  bit: each group's head against the twin's first rows and its host tail
  against the rest, for the payload, the scales and every optimizer
  leaf; the hot buffers and their state whole."""
  tier = tdist.cold_tier
  for key, u in uparams.items():
    t = tparams[key]
    if key.startswith('hot_'):
      ok = same_bits(t, u)
    else:
      gi = int(key.rsplit('_', 1)[1])
      res = tdist.plan.groups[gi].device_rows
      ok = same_bits(t, u[:res])
      if gi in tier.payload:
        what = 'scale' if key.startswith('scale_') else 'payload'
        ok = ok and same_bits(tier_tail(tier, gi, what), u[res:].cpu())
    if not ok:
      raise AssertionError(f'{tag}: {key} differs from the resident twin')
  if tstate is None:
    return
  for key, leaves in ustate.items():
    for leaf, u in leaves.items():
      t = tstate[key][leaf]
      if key.startswith('hot_'):
        ok = same_bits(t, u)
      else:
        gi = int(key.rsplit('_', 1)[1])
        res = tdist.plan.groups[gi].device_rows
        ok = same_bits(t, u[:res])
        if gi in tier.payload:
          ok = ok and same_bits(tier_tail(tier, gi, 'opt', leaf),
                                u[res:].cpu())
      if not ok:
        raise AssertionError(f'{tag}: state {key}/{leaf} differs from the '
                             'resident twin')


def tier_launches(tdist, hotness, per_step):
  """A tiered layer's launches of one cached step from its twin's
  (``hot_launches``): one more lookup a tiered subgroup and chunk round
  (the fetch buffers' gather), the same segment walks; on an unquantized
  plan each tiered group's apply on the two-source arm."""
  subs = tdist._subgroups(tuple(hotness))
  tiered = set(tdist.plan.cold_tier_groups)
  extra = sum(len(tdist._chunk_bounds(s.n_cap)) for s in subs
              if s.gi in tiered)
  fwd = {'lookup_combine': per_step[0]['lookup_combine'] + extra,
         'segwalk_apply': 0}
  step = {'lookup_combine': per_step[1]['lookup_combine'] + extra,
          'segwalk_apply': per_step[1]['segwalk_apply']}
  if tdist.quant is None:
    step['segwalk_apply:two_source'] = len({s.gi for s in subs} & tiered)
  return fwd, step


def captured_tier_step(step, state, cats, batch, fetch):
  """One real tiered step on ``fetch`` that also records the gathers of
  the fetch buffers (``fused_group_lookup`` on a fetch payload) and each
  two-source apply, with compact copies of the rows it touches in the
  head and in the tail (taken before the in-place update)."""
  gathers, applies = [], []
  payloads = {f['payload'].data_ptr(): gi for gi, f in fetch.device.items()}
  fused, apply = lookup.fused_group_lookup, segwalk.segwalk_apply

  def record_fused(table, routed, combiners, compute_dtype, scale=None):
    if table.data_ptr() in payloads:
      gathers.extend((table, r.reshape(-1, r.shape[2]), scale)
                     for r in routed)
    return fused(table, routed, combiners, compute_dtype, scale)

  def record_apply(table, acc, ids, grads, lr, *, op, eps=1e-7, g_index=None,
                   betas=segwalk.BETAS, tail=None):
    if tail is not None:
      res = table.shape[0]
      rows = res + tail.table.shape[0]
      touched = torch.unique(ids[(ids >= 0) & (ids < rows)]).long()
      head, in_tail = touched[touched < res], touched[touched >= res] - res
      applies.append({
          'table': table, 'acc': acc, 'tail': tail, 'ids': ids,
          'grads': grads, 'g_index': g_index, 'lr': lr, 'eps': eps, 'op': op,
          'touched': touched, 'head': head, 'in_tail': in_tail,
          'compact': (table[head], None if acc is None else acc[head],
                      tail.table[in_tail],
                      None if tail.acc is None else tail.acc[in_tail])})
    return apply(table, acc, ids, grads, lr, op=op, eps=eps,
                 g_index=g_index, betas=betas, tail=tail)

  lookup.fused_group_lookup = record_fused
  segwalk.segwalk_apply = record_apply
  try:
    state, loss = step(state, cats, batch, cold_fetch=fetch)
  finally:
    lookup.fused_group_lookup = fused
    segwalk.segwalk_apply = apply
  return state, loss, gathers, applies


def check_two_source(call, label):
  """One captured two-source apply: the kernel against its plain version
  on compact copies of its touched rows (the head's and the tail's, the
  ids remapped in order: the same sorted stream and summation order),
  Adagrad rtol = atol = 1e-6, sgd bit-exact, and the kernel's rows equal
  to what the step wrote, bit for bit; then kernel and plain times on
  the real head and fetch buffers at lr 0 beside the bound."""
  op, ids, touched = call['op'], call['ids'], call['touched']
  table, acc, tail = call['table'], call['acc'], call['tail']
  rows = table.shape[0] + tail.table.shape[0]
  u, n_head = touched.shape[0], call['head'].shape[0]
  valid = (ids >= 0) & (ids < rows)
  cids = torch.where(valid, torch.searchsorted(
      touched.to(torch.int32), ids).to(torch.int32), torch.full_like(ids, u))
  csegs = segwalk.sort_stream(cids, u, call['g_index'])
  ch, cha, ct, cta = call['compact']
  out = []
  for fn in (segwalk.apply_segments, segwalk.apply_segments_reference):
    h, ha, t, ta = (None if x is None else x.clone()
                    for x in (ch, cha, ct, cta))
    fn(h, ha, csegs, call['grads'], call['lr'], op=op, eps=call['eps'],
       tail=segwalk.Tail(t, ta))
    out.append((h, ha, t, ta))
  torch.cuda.synchronize()
  (kh, kha, kt, kta), (ph, pha, pt, pta) = out
  err = max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
            for x, y in ((kh, ph), (kt, pt)) + (
                ((kha, pha), (kta, pta)) if acc is not None else ()))
  if op == 'sgd':
    ok, tol = torch.equal(kh, ph) and torch.equal(kt, pt), 'bit-exact'
  else:
    ok = all(torch.allclose(x.float(), y.float(), rtol=1e-6, atol=1e-6)
             for x, y in ((kh, ph), (kt, pt), (kha, pha), (kta, pta)))
    tol = 'rtol=atol=1e-6 (rsqrt)'
  if not ok:
    raise AssertionError(f'{label}: the two-source arm disagrees with its '
                         f'plain version, max abs err {err} ({tol})')
  head, in_tail = call['head'], call['in_tail']
  stepped = ((table[head], kh), (tail.table[in_tail], kt)) + (
      ((acc[head], kha), (tail.acc[in_tail], kta)) if acc is not None
      else ())
  if not all(same_bits(x, y) for x, y in stepped):
    raise AssertionError(f'{label}: the kernel on the compact copies '
                         'differs from what the step wrote')
  segs = segwalk.sort_stream(ids, rows, call['g_index'])
  nbytes, bound_ms, bound_by = segwalk_bound(segs, call['grads'], table, acc,
                                             op)
  kernel_ms = device_ms(lambda: segwalk.apply_segments(
      table, acc, segs, call['grads'], 0.0, op=op, eps=call['eps'],
      tail=tail), 10, floor_ms=bound_ms)
  plain_ms = plain_ms_of(lambda: segwalk.apply_segments_reference(
      table, acc, segs, call['grads'], 0.0, op=op, eps=call['eps'],
      tail=tail))
  n = segs.sorted_ids.shape[0]
  row = {'stream': label, 'op': op, 'dtype': 'float32',
         'stream_dtype': str(call['grads'].dtype).replace('torch.', ''),
         'acc_dtype': None if acc is None else 'float32',
         'rows': rows, 'res': table.shape[0], 'fetch_rows':
         tail.table.shape[0], 'w': table.shape[1], 'positions': n,
         'segments': segs.count, 'head_rows': n_head,
         'tail_rows': u - n_head, 'longest_segment': segs.longest(),
         'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes,
         'max_abs_err': err, 'tolerance': tol, 'kernel_ms': kernel_ms,
         'plain_ms': plain_ms, 'library_ms': None, 'bound_ms': bound_ms,
         'bound_by': bound_by}
  log('[tier-apply] ' + json.dumps(clocked(row)))
  return row


def phase_tier_tiny(config, seed):
  """Phase 9j: the host-DRAM cold tier on the tiny model at full size
  (see the module docstring).  Returns each arm's numbers and the kernel
  rows."""
  tables, _, _ = expand_tables(config)
  train_sets = hotcache.analytic_power_law_hot_sets(tables, HOT_ALPHA,
                                                    HOT_COVERAGE)
  numbers, rows = {}, {'gather': [], 'apply': []}
  for dtype in TIER_DTYPES:
    tag = f'tier-tiny-{dtype or "f32"}'
    twin = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                          table_dtype=dtype, device='cuda').init(seed + 19)
    udist = twin.dist_embedding
    budget = udist.plan.resident_table_bytes() // 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = SyntheticModel(config, dp_input=True, hot_cache=train_sets,
                           table_dtype=dtype, cold_tier=True,
                           device_hbm_budget=budget,
                           device='cuda').init(seed + 19)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dist = model.dist_embedding
    tier = dist.cold_tier
    check_tier_state(f'{tag} init', dist, model.embedding_params, None,
                     udist, twin.embedding_params, None)
    hotness = tuple(model.hotness)
    fwd_want, step_want = tier_launches(dist, hotness,
                                        hot_launches(udist, hotness))
    geometry = coldtier.tier_stats(dist)
    num = {'budget_bytes': budget, 'init_s': init_s,
           'resident_gib': geometry['cold_tier_resident_bytes'] / 2**30,
           'host_gib': geometry['cold_tier_host_bytes'] / 2**30,
           'groups': {gi: (dist.plan.groups[gi].device_rows,
                           dist.plan.groups[gi].tier_rows)
                      for gi in dist.plan.cold_tier_groups}}
    log(f'[{tag}] budget {budget:,} B (half the resident twin\'s '
        f'{budget * 2:,}): {len(num["groups"])} tiered group(s), resident '
        f'and tail rows {json.dumps(num["groups"])}; {num["resident_gib"]:.3f}'
        f' GiB on the card, {num["host_gib"]:.3f} GiB in host memory; drawn '
        f'in {init_s:.2f} s, equal to the twin\'s draw bit for bit')
    batches = train_batches(config, hotness, seed + 19, TIER_STEPS + 3)
    cats = batches[0][0]
    with torch.no_grad():
      reset_launches()
      got = dist.apply(model.embedding_params, cats)
      fwd_launches = read_launches()
      want = udist.apply(twin.embedding_params, cats)
    if fwd_launches != fwd_want or not all(
        same_bits(g, w) for g, w in zip(got, want)):
      raise AssertionError(f'{tag} forward: launched {fwd_launches} '
                           f'(expected {fwd_want}), or differs from the '
                           'twin\'s')
    del got, want
    log(f'[{tag}] the tiered forward at batch {BATCH} equals the twin\'s '
        f'bit for bit (every hotness); launches {json.dumps(fwd_launches)}')
    # the pre-pass, the fetch and the write-back on one batch
    inputs, _, _ = dist._prepare_inputs(cats)
    t0 = time.perf_counter()
    prepass = coldtier.compute_fetch_rows(dist, inputs)
    prepass_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fetch = coldtier.build_fetch(dist, inputs, rows=prepass)
    torch.cuda.synchronize()
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    coldtier.write_back(dist, fetch)
    write_ms = (time.perf_counter() - t0) * 1e3
    stats = coldtier.fetch_stats(dist, fetch)
    num.update(prepass_ms=prepass_ms, build_fetch_ms=fetch_ms,
               write_back_ms=write_ms,
               fetch_rows=stats['cold_tier_fetch_rows'],
               fetch_bytes=stats['cold_tier_fetch_bytes'],
               fetch_scale_bytes=stats['cold_tier_fetch_scale_bytes'],
               fetch_caps=dist.fetch_caps_for(BATCH))
    log(f'[{tag}] one batch: pre-pass {prepass_ms:.3f} ms, build_fetch '
        f'(host gather + copy) {fetch_ms:.3f} ms, write_back '
        f'{write_ms:.3f} ms (host clock); {stats["cold_tier_fetch_rows"]:,} '
        f'rows, {stats["cold_tier_fetch_bytes"]:,} payload bytes and '
        f'{stats["cold_tier_fetch_scale_bytes"]:,} scale bytes fetched '
        f'(optimizer rows beside them); capacities '
        f'{json.dumps(num["fetch_caps"])}')
    del fetch
    # SparseAdagrad(0.01) steps from the same state, tier and twin
    ustep, ustate = build_trainer(twin)
    tstep, tstate = build_trainer(model)
    runs = {}
    for which, step, state, per in (
        ('twin', ustep, ustate, hot_launches(udist, hotness)[1]),
        ('tiered', tstep, tstate, step_want)):
      state, launches, times, peak = timed_steps(
          f'{tag}-{which}', step, state, batches,
          {k: v * TIER_STEPS for k, v in per.items()}, n_steps=TIER_STEPS)
      runs[which] = {'launches': launches, 'step_ms': times,
                     'peak_gib': peak / 2**30}
      if which == 'twin':
        ustate = state
      else:
        tstate = state
    check_tier_state(f'{tag} after {TIER_STEPS + 1} steps', dist,
                     tstate.params['embedding'], tstate.opt_state[1], udist,
                     ustate.params['embedding'], ustate.opt_state[1])
    num['train'] = runs
    log(f'[{tag}] after {TIER_STEPS + 1} steps the tiered tables and '
        'accumulators (head and host tail) equal the twin\'s bit for bit')
    del ustep, ustate, twin, udist
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at the tier's shapes, on one more captured step
    cats_c, batch_c = batches[TIER_STEPS + 1]
    fetch = dist.build_cold_fetch(cats_c)
    tstate, loss, gathers, applies = captured_tier_step(
        tstep, tstate, cats_c, batch_c, fetch)
    if not bool(torch.isfinite(loss)):
      raise AssertionError(f'{tag} capture step: loss {float(loss)}')
    for table, ids, scale in gathers:
      label = (f'tier_gather_{dtype or "f32"}_w{table.shape[1]}_'
               f'cap{table.shape[0]}_M{ids.shape[0]}')
      rows['gather'].append(
          check_kernel_shape(table, ids, label) if scale is None else
          check_dequant_shape(table, ids, scale, label))
    for call in applies:
      rows['apply'].append(check_two_source(
          call, f'tier_apply_{call["op"]}_w{call["table"].shape[1]}_res'
          f'{call["table"].shape[0]}_cap{call["tail"].table.shape[0]}'))
    if not gathers or (dtype is None and not applies):
      raise AssertionError(f'{tag}: the captured step made no tier gather '
                           f'({len(gathers)}) or two-source apply '
                           f'({len(applies)})')
    # the pipelined pre-pass over more steps
    pipe = coldtier.ColdFetchPipeline(
        dist, (b[0] for b in batches[:TIER_PIPE_STEPS]))
    pipe_ms = []
    for i, ((cats_p, fetch_p), (_, batch_p)) in enumerate(zip(pipe,
                                                              batches)):
      t0 = time.perf_counter()
      tstate, loss = tstep(tstate, cats_p, batch_p, cold_fetch=fetch_p)
      pipe_ms.append((time.perf_counter() - t0) * 1e3)
      if not bool(torch.isfinite(loss)):
        raise AssertionError(f'{tag} pipelined step {i}: loss {float(loss)}')
      if i == 0:
        pipe.reset_stats()
    pipe.close()
    num['pipeline'] = {**pipe.stats(), 'step_ms': pipe_ms}
    if not 0.0 <= num['pipeline']['overlap_pct'] <= 1.0:
      raise AssertionError(f'{tag}: overlap_pct {num["pipeline"]}')
    num['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    log(f'[{tag}] ColdFetchPipeline over {TIER_PIPE_STEPS} steps: '
        f'{json.dumps(num["pipeline"])}; peak device memory '
        f'{num["peak_gib"]:.3f} GiB')
    numbers[dtype or 'f32'] = num
    del tstep, tstate, model, dist, tier, fetch, pipe
    gc.collect()
    torch.cuda.empty_cache()
  return numbers, rows


def tier_summary(k, seg, numbers, rows):
  """Phase 9j's entries of the summary line: each arm's launches, the
  tier's gather shapes on the lookup, and the two-source arm's row."""
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_tier_tiny'] = {
        arm: n['train']['tiered']['launches'][name]
        for arm, n in numbers.items()}
  k['max_abs_err'] = max([k['max_abs_err']]
                         + [r['max_abs_err'] for r in rows['gather']])
  k['tier_tiny'] = {
      'ms': sum(r['kernel_ms'] for r in rows['gather']),
      'plain_ms': sum(r['plain_ms'] for r in rows['gather']),
      'bound_ms': sum(r['bound_ms'] for r in rows['gather']),
      'library_ms': (None if any(r['library_ms'] is None
                                 for r in rows['gather'])
                     else sum(r['library_ms'] for r in rows['gather'])),
      'shapes': [{key: r.get(key) for key in (
          'shape', 'M', 'h', 'w', 'dtype', 'distinct_rows', 'kernel_ms',
          'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'max_abs_err')}
                 for r in rows['gather']]}
  seg['tier_tiny'] = numbers
  launches = numbers['f32']['train']['tiered']['launches'].get(
      'segwalk_apply:two_source', 0)
  return summed(TWO_SOURCE_ARM, launches, rows['apply'])


def dlrm_tier_summary(k, seg, two_source_tiny, launches, rows):
  """Phase 13g's entries of the summary line: its launches; its step-1
  tier gathers on the lookup beside phase 9j's; and the two-source arm's
  row from its own apply on the slice's main path (launches, check,
  times and bound), phase 9j's row kept inside it."""
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_tier'] = launches[name]
  k['max_abs_err'] = max([k['max_abs_err']]
                         + [r['max_abs_err'] for r in rows['gather']])
  k['dlrm_tier'] = {
      'ms': sum(r['kernel_ms'] for r in rows['gather']),
      'plain_ms': sum(r['plain_ms'] for r in rows['gather']),
      'bound_ms': sum(r['bound_ms'] for r in rows['gather']),
      'library_ms': sum(r['library_ms'] for r in rows['gather']),
      'shapes': [{key: r.get(key) for key in (
          'shape', 'M', 'h', 'w', 'dtype', 'distinct_rows', 'kernel_ms',
          'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'max_abs_err')}
                 for r in rows['gather']]}
  tiny = {key: two_source_tiny[key] for key in (
      'launches', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
      'streams')}
  return summed(TWO_SOURCE_ARM, launches['segwalk_apply:two_source'],
                rows['apply'], extra={'tier_tiny': tiny})


def meminfo():
  """``/proc/meminfo`` in bytes (``MemTotal``, ``MemAvailable``...)."""
  out = {}
  with open('/proc/meminfo', encoding='ascii') as f:
    for line in f:
      key, value = line.split(':', 1)
      parts = value.split()
      out[key] = int(parts[0]) * (1024 if parts[1:] == ['kB'] else 1)
  return out


def tier_sizes(budget):
  """The vocabularies of phase 13g: the MLPerf ones, the largest capped
  (10 % at a time) until the host tail the plan leaves plus
  ``TIER_HOST_HEADROOM`` fits ``MemAvailable``; ``(sizes, cut, tail
  bytes)``, ``cut`` None without a cap."""
  from distributed_embeddings_tpu_torch.parallel.planner import (
      ShardingPlan, TableConfig)
  avail = meminfo()['MemAvailable']
  sizes = list(data.MLPERF_SIZES)
  while True:
    plan = ShardingPlan([TableConfig(s, 128) for s in sizes], world_size=1,
                        strategy='memory_balanced', cold_tier=True,
                        device_hbm_budget=budget, packed_storage=False)
    tail = sum(g.tier_rows * plan.row_bytes(g.width) for g in plan.groups)
    if tail + TIER_HOST_HEADROOM <= avail:
      break
    top = max(sizes)
    sizes = [int(s * 0.9) if s == top else s for s in sizes]
  cut = None if sizes == list(data.MLPERF_SIZES) else {
      i: (a, b) for i, (a, b) in enumerate(zip(data.MLPERF_SIZES, sizes))
      if a != b}
  return sizes, cut, tail


def block_hashes(arr, pool, block_rows=1 << 20, patch=None):
  """sha1 of each block of ``block_rows`` rows of a host array, hashed
  in parallel (hashlib releases the GIL); ``patch`` ``(rows, values)``
  hashes the blocks as if those rows held those values."""
  import hashlib

  def one(lo):
    block = arr[lo:lo + block_rows]
    if patch is not None:
      rows, values = patch
      mine = (rows >= lo) & (rows < lo + block_rows)
      if mine.any():
        block = block.copy()
        block[rows[mine] - lo] = values[mine]
    return hashlib.sha1(np.ascontiguousarray(block).view(np.uint8)).digest()

  return list(pool.map(one, range(0, arr.shape[0], block_rows)))


def phase_dlrm_tier(seed):
  """Phase 13g: examples/dlrm/main.py --dataset_path ... --cold_tier_budget_mb
  in process, f32, at the MLPerf vocabularies (see the module docstring).
  Returns the launches and numbers."""
  mem = meminfo()
  budget = int(TIER_BUDGET_MB * 2**20)
  sizes, cut, tail_bytes = tier_sizes(budget)
  log(f'[dlrm-tier] host memory: MemTotal {mem["MemTotal"] / 2**30:.2f} GiB, '
      f'MemAvailable {mem["MemAvailable"] / 2**30:.2f} GiB; the tail the '
      f'plan leaves at {TIER_BUDGET_MB} MB/device: {tail_bytes / 2**30:.2f} '
      f'GiB (+ {TIER_HOST_HEADROOM / 2**30:.0f} GiB headroom); reduced: '
      f'{json.dumps(cut)}')
  if not fastloader.available():
    raise AssertionError('dlrm-tier: the native reader did not build')
  root = CKPT_DIR / 'dlrm_tier_data'
  shutil.rmtree(root, ignore_errors=True)
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(_Tee()):
    gen_data.write_dataset(str(root), sizes, TIER_DLRM_BATCHES * BATCH, BATCH,
                           alpha=DLRM_ALPHA, seed=seed)
  gen_s = time.perf_counter() - t0
  python_reader = data.BinaryCriteoReader(
      str(root), batch_size=BATCH, numerical_features=13,
      categorical_features=list(range(len(sizes))),
      categorical_feature_sizes=sizes, prefetch_depth=10,
      drop_last_batch=True, offset=0, lbs=BATCH, dp_input=True)
  t0 = time.perf_counter()
  n = sum(len(b[2]) for b in python_reader)
  python_sps = n / (time.perf_counter() - t0)
  numerical0, cats0, _ = python_reader[0]
  python_reader.close()
  argv = ['--dataset_path', str(root), '--dp_input', '--hot_cache',
          '--cold_tier_budget_mb', str(TIER_BUDGET_MB), '--param_dtype',
          'float32', '--max_steps', str(TIER_DLRM_STEPS), '--loader_bench',
          '--device', 'cuda']
  pool = concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4)
  checks = {}
  rows = {'gather': [], 'apply': []}
  uncounted = collections.Counter()  # the checks' own launches
  build_ms, write_ms = [], []
  build, write = coldtier._build_fetch, coldtier._write_back
  make_trainer = dlrm_main.make_trainer
  counts = lambda: {**read_launches(),
                    'two_source': segwalk.ARM_LAUNCHES['two_source']}

  def not_counted(fn, *a):
    before = counts()
    out = fn(*a)
    uncounted.update({k: v - before[k] for k, v in counts().items()})
    return out

  def timed_build(*a, **kw):
    t = time.perf_counter()
    out = build(*a, **kw)
    torch.cuda.synchronize()
    build_ms.append((time.perf_counter() - t) * 1e3)
    return out

  def timed_write(*a, **kw):
    t = time.perf_counter()
    out = write(*a, **kw)
    write_ms.append((time.perf_counter() - t) * 1e3)
    return out

  def check_kernels(gathers, applies):
    """Step 1's tier gathers and two-source apply against their plain
    versions at the step's shapes (as phase 9j holds them)."""
    for table, ids, scale in gathers:
      rows['gather'].append(check_kernel_shape(
          table, ids, f'dlrm_tier_gather_w{table.shape[1]}_cap'
          f'{table.shape[0]}_M{ids.shape[0]}'))
    for call in applies:
      rows['apply'].append(check_two_source(
          call, f'dlrm_tier_apply_{call["op"]}_w{call["table"].shape[1]}_'
          f'res{call["table"].shape[0]}_cap{call["tail"].table.shape[0]}'))
    if not gathers or not applies:
      raise AssertionError(f'dlrm-tier step {TIER_CHECK_STEP}: no tier '
                           f'gather ({len(gathers)}) or two-source apply '
                           f'({len(applies)}) captured')

  def before_check(dist, fetch):
    # the rows this step fetches, and a hash of every block of the tails
    tier = dist.cold_tier
    checks['touched'] = {gi: fetch.rows_np[gi] - dist.plan.groups[
        gi].device_rows for gi in dist.plan.cold_tier_groups}
    checks['old'] = {gi: tier.payload[gi][r].copy()
                     for gi, r in checks['touched'].items()}
    stats = coldtier.fetch_stats(dist, fetch)
    checks['fetch'] = {k: stats[k] for k in (
        'cold_tier_fetch_rows', 'cold_tier_fetch_bytes')}
    t = time.perf_counter()
    checks['hashes'] = {gi: block_hashes(tier.payload[gi], pool)
                        for gi in dist.plan.cold_tier_groups}
    checks['hash_s'] = time.perf_counter() - t

  def after_check(dist):
    tier = dist.cold_tier
    changed = total = 0
    for gi, r in checks['touched'].items():
      after = tier.payload[gi][r]
      changed += int((after != checks['old'][gi]).any(axis=1).sum())
      total += r.size
      # every untouched row as it was: each block hashed with the
      # touched rows put back to their old values
      if block_hashes(tier.payload[gi], pool, patch=(
          r, checks['old'][gi])) != checks['hashes'][gi]:
        raise AssertionError(f'dlrm-tier group {gi}: a tail row the step '
                             'did not fetch changed')
    if not total or changed != total:
      raise AssertionError(f'dlrm-tier step {TIER_CHECK_STEP}: {changed} of '
                           f'{total} fetched tail rows changed')
    checks['touched_rows'] = total

  def checked_trainer(model, trainer, learning_rate):
    """The example's trainer, its step wrapped: step 1 captured and
    checked, the last one followed by the forward sample."""
    step, state0 = make_trainer(model, trainer, learning_rate)
    dist = model.dist_embedding
    n = itertools.count()

    def hybrid(state, cats, batch, cold_fetch):
      return step(state, batch[0], cats, batch[1], cold_fetch=cold_fetch)

    def checked(state, numerical, cats, labels, cold_fetch=None):
      i = next(n)
      if i != TIER_CHECK_STEP:
        state, loss = step(state, numerical, cats, labels,
                           cold_fetch=cold_fetch)
      else:
        before_check(dist, cold_fetch)
        state, loss, gathers, applies = captured_tier_step(
            hybrid, state, cats, (numerical, labels), cold_fetch)
        not_counted(check_kernels, gathers, applies)
        del gathers, applies
        after_check(dist)
      if i == TIER_DLRM_STEPS - 1:
        checks['forward'] = not_counted(tier_forward_sample, model, state,
                                        numerical0, cats0)
        checks['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
      return state, loss

    return checked, state0

  torch.cuda.reset_peak_memory_stats()
  coldtier._build_fetch, coldtier._write_back = timed_build, timed_write
  dlrm_main.make_trainer = checked_trainer
  reset_launches()
  out_lines = _Tee()
  t0 = time.perf_counter()
  try:
    with contextlib.redirect_stdout(out_lines):
      out = dlrm_main.main(argv)
  finally:
    coldtier._build_fetch, coldtier._write_back = build, write
    dlrm_main.make_trainer = make_trainer
    pool.shutdown()
    shutil.rmtree(root, ignore_errors=True)
  wall = time.perf_counter() - t0
  launches = {k: v - uncounted[k] for k, v in read_launches().items()}
  launches['segwalk_apply:two_source'] = (segwalk.ARM_LAUNCHES['two_source']
                                          - uncounted['two_source'])
  losses = out['tier_losses']
  if (len(losses) != TIER_DLRM_STEPS or not all(np.isfinite(losses))
      or out['loader'] != 'native' or 'forward' not in checks
      or 'touched_rows' not in checks or min(launches.values()) == 0):
    raise AssertionError(f'dlrm-tier: losses {losses}, reader '
                         f'{out.get("loader")}, checks {sorted(checks)}, '
                         f'launches {launches}')
  tier_line = [l for l in out_lines.lines if l.startswith('cold_tier: ')]
  # the pipeline over the steps past the queue that step 1's checks
  # filled: each batch's pre-pass on the worker and the step's wait
  steady = slice(TIER_STEADY_FROM, None)
  prepass = sum(out['tier_prepass_ms'][steady])
  blocked = sum(out['tier_blocked_ms'][steady])
  numbers = {'sizes_rows': sum(sizes), 'reduced': cut,
             'tail_gib': tail_bytes / 2**30,
             'mem_total_gib': mem['MemTotal'] / 2**30,
             'mem_available_gib': mem['MemAvailable'] / 2**30,
             'gen_data_s': gen_s, 'wall_s': wall, 'losses': losses,
             'step_ms': out['tier_step_ms'],
             'prepass_ms': out['tier_prepass_ms'],
             'blocked_ms': out['tier_blocked_ms'],
             'steady': {'from_step': TIER_STEADY_FROM,
                        'steps': len(out['tier_step_ms'][steady]),
                        'prepass_ms': prepass, 'blocked_ms': blocked,
                        'step_ms': sum(out['tier_step_ms'][steady]),
                        'overlap_pct': (max(0.0, 1.0 - blocked / prepass)
                                        if prepass > 0 else 0.0)},
             'pipeline': out['tier_pipeline'],
             'build_fetch_ms': build_ms, 'write_back_ms': write_ms,
             'loader_native_sps': out['loader_samples_per_s'],
             'loader_python_sps': python_sps,
             'touched_rows_checked': checks['touched_rows'],
             'fetch_step1': checks['fetch'],
             'tail_hash_s': checks['hash_s'], 'peak_gib': checks['peak_gib'],
             'forward': checks['forward'], 'tier_lines': tier_line}
  log(f'[dlrm-tier] {json.dumps(numbers)}; launches {json.dumps(launches)}')
  log(f'[dlrm-tier] every loss finite; at step {TIER_CHECK_STEP} (the first '
      'with a non-zero learning rate) the tier gathers and the two-source '
      'apply equal their plain versions at the step\'s shapes, every one '
      f'of the {checks["touched_rows"]:,} fetched tail rows changed and '
      'every other tail row kept its bytes (sha1 of each block); the '
      f'{checks["forward"]["samples"]}-sample forward equals the plain '
      'gather from head and tail; the native reader ran')
  return launches, numbers, rows


def tier_forward_sample(model, state, numerical, cats, n=512):
  """The tiered model's forward of ``n`` samples against its plain
  version: each input's row gathered where it lives (a hot id's from its
  hot buffer, the others' from the head on the card or the host tail)
  is its embedding output bit for bit, and the head on those rows is
  the forward's logits bit for bit."""
  dist = model.dist_embedding
  plan = dist.plan
  params = state.params
  emb = params['embedding']
  n = min(n, len(cats[0]))
  cats = [np.asarray(c[:n]) for c in cats]
  dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
  tail_hits = hot_hits = 0
  with torch.no_grad():
    outs = dist.apply(emb, cats)
    logits = model.apply(params, numerical[:n], cats)
    plain = []
    for i, tid in enumerate(plan.input_table_map):
      (_, key, off, *_), = plan.shard_layout()[tid]
      gi = next(g for g, grp in enumerate(plan.groups) if grp.key == key)
      res = plan.groups[gi].device_rows
      ids = np.minimum(cats[i], dist.table_configs[tid].input_dim - 1)
      head = emb[f'group_{gi}']
      rows = torch.empty((n, head.shape[1]), dtype=head.dtype,
                         device=head.device)
      local = off + ids
      hot = np.zeros(n, bool)
      hs = plan.hot_sets.get(tid)
      if hs is not None and hs.ids.size:
        pos = np.minimum(np.searchsorted(hs.ids, ids), hs.ids.size - 1)
        hot = hs.ids[pos] == ids
        (hoff,) = [o for t, _, _, o, _ in plan.groups[gi].hot_chunks
                   if t == tid]
        if hot.any():
          rows[dev(np.nonzero(hot)[0])] = emb[f'hot_group_{gi}'][
              dev(hoff + pos[hot])]
      in_head = ~hot & (local < res)
      in_tail = ~hot & (local >= res)
      if in_head.any():
        rows[dev(np.nonzero(in_head)[0])] = head[dev(local[in_head])]
      if in_tail.any():
        rows[dev(np.nonzero(in_tail)[0])] = dev(
            dist.cold_tier.payload[gi][local[in_tail] - res])
      tail_hits += int(in_tail.sum())
      hot_hits += int(hot.sum())
      plain.append(rows)
    for i, (o, p) in enumerate(zip(outs, plain)):
      if not same_bits(o, p):
        bad = (o != p).any(dim=1).nonzero()[:5, 0].tolist()
        raise AssertionError(f'dlrm-tier input {i}: the forward differs '
                             f'from the plain gather at samples {bad}')
    dense = {k: v for k, v in params.items() if k != 'embedding'}
    ref = model.head(dense, numerical[:n], plain)
    if not same_bits(logits, ref) or not bool(torch.isfinite(logits).all()):
      raise AssertionError('dlrm-tier: the logits differ from the head on '
                           'the plain gather')
  return {'samples': n, 'inputs': len(plain), 'tail_rows': tail_hits,
          'hot_rows': hot_hits, 'bit_exact': True}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
          'False); this script runs on the GPU only', file=sys.stderr)
    return 1
  global T_START
  T_START = time.perf_counter()
  card = phase_card()
  phase_build()
  elapsed('phases 1-2')
  k, seg, adam = run_tiny(args, card)
  gc.collect()
  torch.cuda.empty_cache()
  log(f'[dlrm] after the tiny model: device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, '
      f'{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved')
  quant_tiny = run_quant_tiny(args)
  elapsed('phase 9g')
  gc.collect()
  torch.cuda.empty_cache()
  wire_summary(k, seg, phase_wire_ranks(args.seed))
  elapsed('phase 9h')
  dcn_summary(k, seg, phase_dcn_ranks(args.seed))
  elapsed('phase 9i')
  two_source = tier_summary(k, seg, *phase_tier_tiny(
      SYNTHETIC_MODELS[MODEL], args.seed))
  elapsed('phase 9j')
  gc.collect()
  torch.cuda.empty_cache()
  run_dlrm(args.seed, k, seg)
  elapsed('phases 10-13')
  gc.collect()
  torch.cuda.empty_cache()
  resume_launches, resume_numbers, serve_ckpt = phase_dlrm_resume()
  elapsed('phase 13b')
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_resume'] = {run: n[name]
                                     for run, n in resume_launches.items()}
  seg['dlrm_resume'] = resume_numbers
  gc.collect()
  torch.cuda.empty_cache()
  serve_launches, serve_rows, seg['dlrm_serve'] = phase_dlrm_serve(
      serve_ckpt, card)
  elapsed('phase 13h')
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_serve'] = {arm: n[name]
                                    for arm, n in serve_launches.items()}
  k['dlrm_serve'] = serve_rows
  gc.collect()
  torch.cuda.empty_cache()
  ranks_launches, k['dlrm_serve_ranks'], seg['dlrm_serve_ranks'] = (
      phase_dlrm_serve_ranks(serve_ckpt, card))
  elapsed('phase 13i')
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_serve_ranks'] = {
        rank: n[name] for rank, n in ranks_launches.items()}
  dlrm_hot_launches, dlrm_hot_numbers = phase_dlrm_hot()
  elapsed('phase 13c')
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_hot'] = dlrm_hot_launches[name]
  seg['dlrm_hot'] = dlrm_hot_numbers
  gc.collect()
  torch.cuda.empty_cache()
  dlrm_chunked_numbers, dlrm_chunked_rows = phase_dlrm_chunked(args.seed)
  elapsed('phase 13d')
  chunked_summary(k, seg, 'chunked_dlrm', dlrm_chunked_numbers,
                  dlrm_chunked_rows, {'forward': 'forward_launches',
                                      'sparse': 'steps',
                                      'example': 'example'})
  gc.collect()
  torch.cuda.empty_cache()
  dequant = dequant_summary(quant_tiny, run_dlrm_int8(args.seed))
  elapsed('phase 13e')
  seg['quant'] = {
      'dlrm_int8': dequant['dlrm_int8']['launches']['segwalk_apply'],
      **{dtype: t['numbers']['launches']['segwalk_apply']
         for dtype, t in dequant['quant_tiny'].items()}}
  gc.collect()
  torch.cuda.empty_cache()
  wire_launches, _ = phase_dlrm_wire(args.seed)
  elapsed('phase 13f')
  for entry, name in ((k, 'lookup_combine'), (seg, 'segwalk_apply')):
    entry['launches_dlrm_wire'] = wire_launches[name]
  gc.collect()
  torch.cuda.empty_cache()
  tier_launches_dlrm, seg['dlrm_tier'], dlrm_tier_rows = phase_dlrm_tier(
      args.seed)
  elapsed('phase 13g')
  two_source = dlrm_tier_summary(k, seg, two_source, tier_launches_dlrm,
                                 dlrm_tier_rows)
  for tag, run in (('tiny', lambda: run_dense_tiny(args.seed, k)),
                   ('dlrm', lambda: run_dense_dlrm(args.seed))):
    gc.collect()
    torch.cuda.empty_cache()
    log(f'[dense-{tag}] before the model: device memory '
        f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated')
    dk, dseg = run()
    elapsed(f'dense-{tag}')
    k.setdefault('dense', {})[tag] = dk
    seg.setdefault('dense', {})[tag] = dseg
  gc.collect()
  torch.cuda.empty_cache()
  log(f'[small] before the model: device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated')
  arms = run_small(args.seed, k, seg)
  elapsed('phases 17-19')
  gc.collect()
  torch.cuda.empty_cache()
  csr = phase_ragged_lookup()
  log(f'[done] all phases passed in {time.perf_counter() - T_START:.1f} s')
  log(json.dumps({'kernels': clocked([k, seg, *arms, adam, csr, dequant,
                                      two_source])}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
