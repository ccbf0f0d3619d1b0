#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. card     torch/CUDA versions and ``nvidia-smi`` name and power limit;
2. build    compile the CUDA kernels (``gordo_components_torch/ops/csrc``)
            with nvcc for sm_90a, one nvcc per source, all at once; each
            library's kernels, most registers and most local-memory
            (spill) bytes a thread, by cuobjdump;
3. parity   hold each kernel against its plain PyTorch version on the card.
            Banked anomaly score (K2): its packed result at the serving
            shapes (B=64, F=10, M=10000, T=64 dense and 97 LSTM), ragged
            shapes, one 8192-row slot, a slot width that is not a multiple
            of 4 and lane-group edges (F = 1..130 at T = 64 and 97): output
            copy, diff and scaled bitwise, norms within rtol=atol=1e-6; its
            device time at both serving shapes and at B=T=1 (floor_us).
            Per-model anomaly score (K1): the serving shape's one request
            and ragged shapes, same bands. K1 and K2 again with NaN, +inf
            and -inf in the output, the target and one member's scale row,
            at the serving shapes: NaN and infinities where the plain
            version has them, the finite elements in the same bands. For both, device operations per
            call (at most 1, asserted) and the host time of each piece of
            the wrapper. Fused LSTM step (K3): one step
            (S=1) within rtol=atol=1e-6 and an S-step layer within
            rtol=1e-5, atol=1e-6, at the serving shape (S=32, B=97 windows,
            M=64 slots, H=8), ragged H, B and M, and the edges of its
            design (H = 7, 16, 31, 32, 33 at S = 1, 5, 33, and 97 windows
            of one member), and the shapes training and building give it
            (128 windows of 1,024 members at H = 8, 7, 5; one member's 128
            and 1,409 windows; the build's lookbacks 10, 12, 16 at its gang
            widths and H down to 1; the cv phase's 8-member gang at batch
            100, and 221, 473 and 725 windows of one member); its reciprocal
            bitwise against the IEEE division over every float in
            [1, 2^126); K3-bf16's self-tests, each finding 0 mismatches:
            all 65,536 bf16 codes through its gate tables against the cell's
            formula, its packed bf16 add and multiply against float32 then
            round over all 2^32 pairs of codes (and its packed conversion
            over all 2^32 floats); each lstm_hourglass
            layer's device time at the serving shape against its bound; both
            K3 wrappers refuse a CUDA input that requires grad (the kernel has
            no backward). Each kernel, its plain version
            and a library expression are timed with CUDA events; K1 and its
            library call again in turns, 100 rounds of one call each;
   bf16_kernel  K3's bfloat16 instance (bf16 xz, Wh and b; f32 h, c and
            results) against its bfloat16 plain version, one step and a
            layer, at the serving shape, the ragged and edge shapes above and
            H = 5 and 7 for one member's 97 windows (odd B*M*H: every other
            step starts 8 bytes off a 16-byte line): each within its least
            share of values bitwise equal and its most error in bf16 ulps
            (K3_BF16_*), while the fp32 instance on the same inputs cast up
            (a kernel that skips the bf16 roundings) must fall outside
            them at every shape, and the design equals the arithmetic
            design (the yardstick gordo_lstm_steps_bf16_arith, which only
            this script calls) bit for bit at every shape; its device time beside
            the fp32 instance's, ms, plain_ms, library_ms and the bound;
            bf16_lstm_layers: both designs' device us, launched in turns,
            at every lstm_hourglass layer of the serving batch against the
            bound, for one member and at the error passes' 128 x 1,024
            training shapes;
4. train    FleetTrainer at the reference bench's fleet width (1,024
            members x 1,440 rows x 10 tags, feedforward_hourglass, 5 epochs,
            batch 128, float32) on the card: a warm fit, then a timed fit of
            the same shapes; models/hour, the fit's wall seconds, per-epoch
            seconds; the device operations of one training step and the
            device's busy share of one epoch (profiler); the share of members
            whose loss fell from epoch 1 to epoch 5 (at least 0.99);
5. train_parity  an 8-member fleet (256 rows, one batch an epoch, 3 epochs)
            from the same initial parameters fitted on the card and on the
            CPU: parameters, losses, error scalers and thresholds within
            TRAIN_RTOL/TRAIN_ATOL (the band tests/test_torch_fleet.py holds
            the port to against the JAX package);
   seq_train  the reference bench's config 2 as one fit: LSTMAutoEncoder
            (lstm_hourglass, lookback 32, 5 epochs, batch 128) on one member
            of the bench's fleet (1,440 rows x 10 tags, float32): a warm
            1-epoch fit, then the timed fit (models/hour, fit and epoch
            seconds, the loss falling from epoch 1 to 5); then the single
            build's detector fit of that estimator (SEQ_CHECK_EPOCHS), whose
            predict runs K3 (its launches); a fit with a validation split of
            0.2 and early stopping (SEQ_CHECK_EPOCHS), whose K3 launches must be exactly its validation
            passes' (epochs run x validation batches x layers: the training
            steps launch none); one training step's device operations and
            host launch time, and the device's busy share of one epoch
            (profiler);
   seq_fleet  FleetTrainer of the same model at the bench's fleet width
            (SEQ_FLEET_MEMBERS x 1,440 rows x 10 tags): a warm 1-epoch fit,
            then the timed 5-epoch fit: models/hour, fit and epoch seconds,
            peak device memory, K3 launches of the error pass (two passes,
            every batch, every layer), the share of members whose loss fell
            (at least 0.99), step device operations and epoch busy share;
   seq_train_parity  8 LSTM members of ragged rows, one batch an epoch, 3
            epochs, from the same initial parameters on the card and on the
            CPU, at q = 1, at q = 0.99, and at q = 1 with a validation split
            and early stopping (patience 1, a min_delta no epoch beats: all
            stop after epoch 2 and restore epoch 1), then one member's
            single fit with the same validation and early stopping:
            parameters (restored ones), losses, validation losses, input and
            error scalers and q = 1 thresholds within LSTM_RTOL/LSTM_ATOL,
            q = 0.99 histogram thresholds within two bins;
   zoo_train  the reference bench's config 4 as one fit a model:
            ``ConvAutoEncoder`` (default channels (32, 16), lookback 32) and
            ``AutoEncoder(kind="feedforward_variational")`` (default widths,
            the ELBO), one member of the bench's fleet (1,440 rows x 10
            tags), 5 epochs, batch 128, float32: a warm 1-epoch fit, then the
            timed fit (models/hour, fit and epoch seconds, the loss falling);
            each one's detector fit and its ``anomaly()`` (one K1 launch, no
            training row above its threshold); one step's device operations
            and host launch time, and an epoch's busy share (profiler);
   zoo_fleet  FleetTrainer of config 4 at the bench's zoo-fleet shape (256
            members x 720 rows x 10 tags, 3 epochs, batch 128,
            host_sync_every=3): the conv family at channels (16, 8), lookback
            32, and the variational one at (64,) -> 8; a warm fit, then the
            timed fit (models/hour; the loss fell for at least 0.99 of the
            members); a bank of what each trained scores every member's
            training rows (K2): no scaled error above its threshold;
   zoo_parity  8 conv and 8 variational members from the same initial
            parameters on the card and on the CPU (256 rows, one batch an
            epoch, 3 epochs, a validation split of 0.2; the variational noise
            from the port's generators, the same on both): parameters,
            losses, validation losses, scalers, error scalers and thresholds
            within TRAIN_RTOL/TRAIN_ATOL;
   bf16_train  the reference bench's bfloat16 legs at their own shapes:
            the dense fleet (1,024 x 1,440 x 10, 5 epochs, batch 128),
            config 2's LSTMAutoEncoder (lookback 32) with a validated fit
            whose K3 launches must all be the bf16 instance's (epochs run x
            validation batches x layers), config 4's conv and variational
            fits and their detectors' ``anomaly()`` (K1): models/hour, fit
            and epoch seconds, step device operations and launch ms, epoch
            busy share, each beside the same run's fp32 phase;
   bf16_parity  one bf16 detector a family (dense, variational, LSTM,
            conv; 256 rows, one batch an epoch, 3 epochs) on the card and on
            the CPU: losses within rtol 1e-3, 98% of the parameters within
            1e-4 and all within 2 * lr a step (tests/test_torch_bf16.py's
            band against JAX); the card detectors in a bank, its scores
            against their ``anomaly()`` within TRAIN_RTOL/TRAIN_ATOL;
6. http     serve a six-bucket directory of port artifacts with
            ``run_server``: 64 feedforward detectors at 10 tags, 8 at 40,
            8 ``LSTMAutoEncoder`` + 4 ``LSTMForecast`` detectors
            (``lstm_hourglass``, 10 tags, lookback 32), 4 conv (lookback 32)
            and 4 variational detectors. Concurrent anomaly/prediction POSTs
            (64 rows feedforward and variational, 128 rows LSTM and conv),
            each held against the port's plain computation on the CPU, with
            the windowed responses' index trimmed by the warm-up offset; a
            bad body (400), a request within the warm-up (400), an unknown
            target (404); the detectors' ``anomaly()`` on the card; the conv
            and variational buckets' K2 and K1 launches counted apart;
7. bank     10,000 feedforward hourglass members at 10 tags scored by 64
            clients x 4 requests x 64 rows through BatchingEngine(max_batch=64,
            flush_ms=2.0): latency, rows/s, average batch; then one full
            batch of 64 requests alone: its host wall time against its
            device time (profiler), and the costliest device operations;
8. lstm     the same for 10,000 ``lstm_hourglass`` members (10 tags,
            lookback 32) and 128-row requests (97 scored rows each), with the
            fused-LSTM-step launches per batch;
   zoo_bank the same for 10,000 config-4 conv members (default channels,
            10 tags, lookback 32: 235 MB of float32 weights), 128-row
            requests, in the LSTM band;
   bf16_bank  the lstm phase with bf16 members (bench.py:1286-1295's
            serving bank), then the bank phase with bf16 members (both held
            to the CPU within the JAX suite's bf16 band, BF16_ATOL x max(1,
            |x|), and the model output within BF16_BANK_VS_CPU); then a bank of 16 dense and 8 LSTM detectors each beside
            its bf16 twin: four buckets, every bf16 twin's scores equal to
            its ``anomaly()`` on the card within TRAIN_RTOL/TRAIN_ATOL and
            apart from its fp32 twin's;
9. build    ``build_fleet`` on the card: 16 RandomDataset machines with the
            default model config (10 tags, 7 days at 10 min), one bespoke
            machine (a bare AutoEncoder: the single-build path), the
            ``turbine-lstm`` machine of examples/fleet.yaml (2 tags, lookback
            12, 5 epochs), 4 LSTMAutoEncoder and 2 LSTMForecast machines at
            the default estimator config (three LSTM gangs), 2 conv and 2
            variational machines at their default estimator configs (two
            more gangs), one bespoke LSTM detector (single build) and two
            configs that are not detectors (a bare Pipeline, a bare
            AutoEncoder: single builds) into a temporary directory: all 79
            built; the directory loaded by a ModelCollection, its detectors
            served by ``ModelBank.from_models`` (the two others left out
            with their reasons, and scored by their own ``predict``) and a
            BatchingEngine, each detector's
            training rows scored as one request (K2, and K3 for LSTM buckets)
            and by ``serializer.load(dir).anomaly`` (K1, and K3), the two held
            together within the http phase's band; no scaled training error
            above its threshold (q = 1) beyond that band;
10. cli     the port's CLI as subprocesses on the card, each within
            CLI_TIMEOUT_S: ``build-fleet`` of examples/fleet.yaml (3 of 3
            built), ``run-server`` on the result on a free port (its model
            list; one anomaly POST a machine with its training rows, held
            against ``serializer.load(dir).anomaly`` here within the http
            phase's bands; SIGTERM, then exit 0), ``build`` with
            ``EVALUATION_CONFIG`` of 3 folds and ``--print-cv-scores`` (3
            finite folds), ``build`` of a config that does not parse (exit
            81) and ``build-fleet`` of a payload whose second machine names an
            unknown model (exit 84, that machine under ``failed``). Each run
            is ``python -m gordo_components_torch.cli`` in a fresh interpreter
            that writes its launch counts and K3 shapes as it exits: the path's
            counts are theirs, summed (build-fleet's LSTM error passes launch
            K3; run-server's buckets launch K2 for every POST, and K3), not
            this process's ``anomaly()`` checks;
11. cv      ``build_fleet`` of 16 dense machines (the default model config)
            and 4 ``LSTMAutoEncoder`` machines (``lstm_hourglass``, lookback
            32), each 10 tags x 1,008 rows with 3 cross-validation folds, and
            one ``cross_val_only`` machine: every gang machine carries 3 finite
            folds of all four metrics and ``fleet_cv``; ``cv_fold_members`` is
            96 and 12; the cross_val_only machine is untrained, unregistered
            and not served; K3 launches in the fold scoring; the first machine
            of each family cross-validated alone (``cross_val_only``: the same
            folds): every fold's four metrics within TRAIN_RTOL/TRAIN_ATOL
            (dense) and LSTM_RTOL/LSTM_ATOL (LSTM) of the gang's, since the
            gang's first member shares the single build's initial parameters
            and shuffles; models/hour and wall seconds;
    cv_parity  8 dense and 4 LSTM machines of the cv phase: the fold plan,
            the fold members' training from the same initial parameters (one
            batch an epoch, 3 epochs) and their scores on the card and on the
            CPU: fold indices equal, scores within TRAIN_RTOL/TRAIN_ATOL
            (dense) and LSTM_RTOL/LSTM_ATOL (LSTM);
    path_parity  each kernel against its plain version, in the parity
            phase's band, at every shape that a call on the card gave it
            from the train phase on (this process's and the CLI runs') and
            that the parity phase did not hold: K1 at every (rows, F) of an
            ``anomaly()``, K2 at every (B, T, F, M) of a bank batch or a
            fleet's scoring, K3 at every (S, B, M, H);
12. collection  a mixed collection built on the card with
            ``provide_saved_model`` (10 tags, 1,008 rows, 3 epochs): a dense
            detector (``feedforward_hourglass``), an LSTM detector
            (``lstm_hourglass``, lookback 10), a bare ``AutoEncoder`` and a
            bare ``Pipeline(MinMaxScaler, LSTMAutoEncoder)``, served over
            HTTP with the bank on: ``/models`` banks the two detectors and
            gives the two others their reasons; ``prediction`` of every model
            (128 rows) against the model's own ``predict`` (the detectors in
            the http and LSTM bands, the bare models bitwise);
            ``anomaly/prediction`` of the detectors through K2 (held against
            their ``anomaly()``), 422 for the others; ``/healthz`` ok,
            ``/ready``, ``metadata-all?digest=1``; ``download-model`` of each,
            loaded, predicting bitwise as the served model. Then a thread
            POSTs without pause to the targets that stay while a new
            detector is built into the directory and a bare model removed,
            each followed by ``POST /reload``: no answer other than 200,
            generation 2, the new target scored through K2. Then the same
            directory served with ``GORDO_SERVER_BANK=0``: each detector's
            anomaly POST launches K1 (and no K2) and answers the banked body
            within the JAX suite's bank-vs-per-model band (rtol 1e-4, atol
            1e-5); the bare Pipeline's prediction launches K3. Before that,
            the new detector is rebuilt into its served directory twice,
            once through ``serializer.dump`` and once through the build
            cache's mirror (``provide_saved_model`` with a register), while a
            thread POSTs to it and calls ``/reload`` in a loop: every answer
            200, no reload reports it removed, and the last answers equal the
            mirrored build's ``anomaly()``. The phase's walls, each step's
            K1/K2/K3 launches and the swaps' pause_ms;
    lake    real data through the port's CLI in subprocesses, as ``cli``
            (``import pyarrow`` blocked in each, and asserted blocked): a
            fleet file in its own directory with four machines, built by
            ``build-fleet`` and served by ``run-server``: ``lake-dense``, the
            examples/README.md lake machine (GRA-T1 on asset-a, NCS CSV;
            IROC-A on asset-b, the IROC dump; 2020-01-01..10; the default
            detector), ``lake-lstm`` (every 2020 tag of the lake,
            2020-01-01..17, an ``lstm_hourglass`` detector at lookback 32,
            and a ``row_filter`` that drops some rows: rows_after_filter
            below rows_after_dropna) and ``influx-machine`` (GRA-T1 and
            GRA-T2 through ``InfluxDataProvider`` from a stub on loopback that
            answers the Influx 1.x ``/query`` dialect with the lake's CSV
            values and RFC3339 times; its rows equal the lake's bitwise)
            and ``lake-parquet`` (GRA-T1, GRA-T2 and GRA-P1, 2020-01-01 to
            2021-01-18: each tag's 2020 CSV and its 2021 parquet, read by the
            port's own parquet reader; LAKE_PARQUET_2021_ROWS rows of 2021,
            as the JAX package's get_data() gives them on the CPU).
            One anomaly POST a machine held against ``anomaly()`` here in the
            cli phase's bands; then examples/parquet/post_body.parquet and
            post_body_y.parquet (the JAX client's encoding of 48 rows of
            2021, the second with ``__y__`` targets) POSTed to lake-parquet as
            ``application/x-parquet`` and as JSON of the same rows: the two
            answers equal. K2 at least once a POST and K3 in the server
            run, K3 in the build run. Each dataset's rows, ``tag_loading`` and
            seconds;
    definitions  one fleet file through the CLI (``build-fleet``, then
            ``run-server``) at BASELINE config 1's width
            (``feedforward_hourglass``, 10 tags, a week of RandomDataset at
            10 min) with one machine per preprocessing definition the JAX
            package builds: RobustScaler(), RobustScaler(with_centering=
            False), MaxAbsScaler() and StandardScaler(with_std=False) in the
            bank (K2 on every POST), PCA(n_components=3) and FeatureUnion(
            [MinMaxScaler, PCA(2)]) on the per-model path (``/models``
            coverage names each under ``fallback`` as non-affine; K1 in
            their ``anomaly()``), a bare TransformedTargetRegressor over
            an AutoEncoder served by its ``predict``, and a MinMaxScaler
            detector over a year resampled at business days (``B``: a
            calendar resolution, in the bank). Each answer held to
            the same artifact's CPU answer in check_arrays' bands; build
            seconds, server-ready seconds and the launches of each run;
    observe  ``run_server`` on the card over four models at config 1's
            width: a dense ``feedforward_hourglass`` detector and an
            ``lstm_hourglass`` one (lookback 32) in the bank, a PCA(3)
            detector on the per-model path (K1), and a copy of the dense one
            whose first weight matrix is NaN. 8 JSON and 4 parquet anomaly
            POSTs to each sound model (examples/parquet/
            post_body_10tags.parquet) from 12 threads and 3 unknown routes:
            ``/stats`` and the port's parse of ``/metrics`` give the same
            integers (requests by kind, errors, the engine's requests and
            batches, each bucket's calls, the wire by encoding), and
            ``gordo_device_hbm_bytes_in_use`` lies between the bank's tensor
            bytes and ``bytes_limit``. The NaN member's three POSTs (at once
            with the sound members', whose bodies stay within the http
            band of their answers alone) answer 200 with non-finite totals;
            in one bank batch its slots leave the neighbours' results
            bitwise those of the same batch with a sound member there; the
            fourth POST answers 410 and launches no kernel, ``/healthz`` is
            degraded and names it, ``gordo_quarantined_models`` is 1, the
            sound members still answer; ``quarantine/clear`` re-admits it
            (three more NaN answers, then 410), and a rewrite with sound
            weights and ``/reload`` drop the verdict (finite answers). POSTs
            with ``X-Gordo-Deadline-Ms: 0.001`` to the bank and the per-model
            path answer 504 with the request id echoed, launch nothing, add
            2 to the engine's ``deadline_expired`` and nothing to the
            breaker. Behind admission, on a bank of the dense and LSTM
            members: a request whose 20 ms budget runs out while a 200 ms
            flush holds its batch is dropped before dispatch and launches
            nothing, and a batch deadline that passes after the dense
            group launches no K3 and leaves the dense result bitwise its
            answer alone. ``metadata-all?digest=1`` gzipped equals the plain body.
            Then the bank phase's closed loop (64 clients x 4 requests of 64
            rows, 10,000 dense members) through an engine and bank with a
            registry and with ``registry=False``: one untimed loop each, then
            5 rounds in the order with, without, without, with: p50, p99 and
            rows/s of each run and each side's medians (findings, not a
            claim);
    pipeline  the bank's pipeline: a bank of 1,000 members each of dense,
            ``lstm_hourglass`` (lookback 32), conv, dense bf16 and
            ``lstm_hourglass`` bf16 (K3-bf16) members at 10 tags, built
            through ``GORDO_BANK_INFLIGHT`` at 1, 2 and 4, scores 200
            back-to-back batches of 64 requests (40-400 rows from a seed,
            request i to family i % 5, each family's first one 257 rows or
            more, so every group pads to (16, 512)): every result bitwise
            window 1's, the page-locked arena's misses the same after the
            first batch and the last, its pooled bytes, the in-flight peak,
            the overlap ratio and the ledger's device seconds beside the
            CUDA-event seconds of the same groups; the engine's closed loop
            (64 x 4 requests of 128 rows) at windows 1 and 2; then
            ``run_server`` with every request traced over one member of the
            first four families and a PCA(3) detector: a POST carrying a
            ``traceparent`` has the ``queue_wait``, ``coalesce``, ``pad``,
            ``device_execute`` and ``postprocess`` spans under
            ``/traces?id=`` (its ``X-Request-Id``), ``/traces/slow`` and the
            Chrome export parse, ``/stats`` names the last trace as its
            latency bucket's exemplar, ``/slo?refresh=1`` and
            ``/costs?refresh=1`` answer (the card's peak, ``device``, and a
            finite MFU a bucket), the new planes' ``/stats`` and
            ``/metrics`` integers are equal, and the PCA detector's POST has
            its ``device_execute`` span over K1; last, an HTTP closed loop
            (16 x 4 POSTs of 64 rows) against a server with the tracer,
            ledger, SLO tracker and cost model on and one with
            ``GORDO_TRACE_SAMPLE=0``, ``GORDO_SLO=0`` and ``GORDO_COST=0``.
            Both A/Bs: medians of 10 runs a side in the order a, b, b, a
            (findings, not a claim);
    qos     QoS, heat, events, history and reload warm-up on the card. The
            fair queue under a flood: a bank of 1,000 members each of dense,
            ``lstm_hourglass``, conv and dense bf16 behind one engine, three
            threads submitting 64 interactive, 64 batch and 512 best_effort
            requests of 64 rows at once (default weights): each class's
            share of the dequeues while all three are backlogged against
            its weight's share, interactive p50 and p99 with and without
            the flood (medians of 5 runs each), every result within the
            observe phase's bands of the same request scored alone. Then a
            server over 20 config-1 dense detectors and a NaN copy, with a
            tenant limited to 5 requests/s and the history sampled every
            second: member i gets 20 - i POSTs and ``/heat?refresh=1&top=5``
            ranks the first five in order, its tiers adding up to the bank;
            the NaN member's quarantine enter and clear; ``/reload`` with
            the hottest member rewritten in bf16: before any request the
            new bank's arena holds the warm shapes (C5), the ranking stands
            and the member's bucket is the new one; a reload under a POSTing
            thread keeps its answers 200 and under 250 ms; 5 warm and 5
            ``GORDO_SERVER_WARMUP=0`` reloads in turns, each followed by a
            POST of a warm shape, whose latency is read (the cold arena
            empty before it); the tenant's sixth POST in a second answers
            429 ``tenant_rate``, a best_effort POST with the engine held at
            its shed depth 429 ``queue_pressure``, and ``/qos`` equals the
            ``gordo_qos_*`` and ``gordo_engine_class_*`` integers of
            ``/metrics``; ``/events`` lists the enter, the clear and every
            reload's ``bank.swap`` and ``models.reload`` at their
            generations; 60 POSTs over 3 s are what the history's
            ``gordo_server_requests_total`` rates add up to, within one
            interval, and the store stays under its memory bound. Last, the
            pipeline phase's HTTP loop with heat, history and a tenant off
            and on (medians of 10 runs a side; findings, not a claim);
    wire    the tensor wire format and the local transports: 16 config-1
            dense detectors and 4 ``lstm_hourglass`` detectors (10 tags,
            lookback 32) served banked (K2, K3) by a pool with a Unix socket
            and the shared-memory ring, and per model (K1, K3) by a second
            server with ``GORDO_SERVER_BANK=0``. Each family's JSON POST and
            its tensor twin on both paths and both endpoints: the tensor
            arrays bitwise the JSON values; one tensor body over TCP, the
            socket and the ring: the same bytes; a truncated body 400 with
            the reason over each; a quarantined target 410 over the socket
            and the ring; a ``__meta__`` tenant over its bucket 429 on the
            ring. 64 tensor POSTs at once, each on its own connection, to a
            4-worker and a 1-worker server scoring each request alone
            (``bank_max_batch=1``): every worker counts some, the answers
            bitwise equal request by request. Readings (findings, not a
            claim; medians of 10 runs a side in turns): the pipeline phase's
            HTTP loop (16 x 4 POSTs of 64 rows) JSON against tensor over TCP,
            with the ``parse`` span's median by encoding and the answer
            bytes a request; tensor over TCP against the socket against the
            ring; 64 x 2 tensor POSTs to 1 worker against 4;
    client  the bulk client on the serving path: 16 config-1 dense and 4
            ``lstm_hourglass`` detectors with ``RandomDataset`` metadata,
            banked (K2, K3) behind a pool with a Unix socket and the ring,
            and per model (K1, K3) on a ``GORDO_SERVER_BANK=0`` server.
            ``Client.predict`` of every target over 576 rows in chunks of
            100 over tcp/JSON, tcp/tensor, uds/tensor and shm/tensor: each
            run (10 chunks at once) and the per-model run within the
            families' bands of each detector's ``anomaly()`` here, and the
            four rungs run one chunk at a time bitwise each other; a tenant
            over its bucket: every retry sleeps at least ``Retry-After``,
            and the server sees the chunks and the budget's retries, no
            more; the two servers as replicas, a hedge after 1 ms: hedges
            counted, every target within its band. Readings: each rung's
            rows/s and wall, request bytes a row by encoding, retries,
            hedges and wins. The cli phase runs the CLI's ``client
            metadata``, ``client predict --parquet-dir`` (each file read
            back and held against ``anomaly()``) and ``client
            download-model`` against its ``run-server``;
    resilience  checkpoint and resume, heartbeats, build traces and fault
            points at config 1's width (10 tags, 1,440 rows a member). (a) a
            256-member dense fleet (6 epochs, batch 128, validation 0.1,
            patience 2) and a 16-member LSTM fleet (lstm_hourglass, lookback
            32, 4 epochs) each killed by its epoch callback and resumed: the
            epochs the resume ran, and its fit held against an uninterrupted
            one, bitwise where two uninterrupted fits are, else each array
            within TRAIN_RTOL/TRAIN_ATOL; (b) steady epoch seconds with
            ``checkpoint_every=1`` against none (order none, every, every,
            none) at 256 dense and 64 LSTM members, the ``checkpoint``
            spans' seconds, each piece of a span (generator states, the
            wait for the writer, the commit, the copy to the host, the
            histories' copy) and the writer's, and a save's bytes; (c) ``build-fleet
            --checkpoint-dir --state-dir --gang-id`` over 4 LSTM and 8 dense
            machines SIGKILLed once the heartbeat reads training at epoch 2,
            then run again: fewer epochs for the killed bucket in
            ``build_trace.json``, the heartbeat ``done``, the checkpoint
            directory empty, ``checkpoint-prune`` removing a stale key, and
            ``run-server`` serving every machine within the bands of its
            ``anomaly()`` (K2, K3); (d) ``fleet_build.group=error,times=1``
            gives one retry and a full build; a server with
            ``bank.finalize`` failing once serves that bucket's members per
            model (K1) within the bands, ``/healthz`` degraded; ``bank.score``
            leads to 400, 400, 400, 410; ``server.connection=reset,times=1``
            is retried through by ``Client.predict``; ``/events`` lists each
            ``fault.fired``; the disarmed ``bank.score`` point's cost in
            ``score_many`` against a no-op stub, interleaved rounds (a
            reading, no limit). The references (each machine's
            ``anomaly()`` in this process) run between the counted
            segments, so the phase's launches are the fits', builds' and
            servers' alone, and the per-model POSTs' own K1 must cover the
            members sent per model;
    quantized  the low-precision bank (``GORDO_BANK_DTYPE``): a
            10,000-member ``feedforward_hourglass`` bank, a 1,000-member
            ``lstm_hourglass`` bank (lookback 32) and the same LSTM bank
            computing in bfloat16 (K3-bf16), 10 tags, each at float32,
            bfloat16 and int8 storage (the bf16-compute one at float32 and
            int8), driven by 64 clients x 4 requests through the engine
            (``max_batch`` 64): stored and float32 bytes, capacity ratio,
            members a GiB, ``memory_allocated`` after the build, p50, p99,
            rows/s, launches, and every array within rtol 0.02 / atol 0.05
            of the float32-storage bank's on the same requests; no
            quantization may fall back;
    stream  the streaming plane: 16 dense and 4 ``lstm_hourglass``
            detectors (10 tags) fitted on the card on
            ``SimulatedLiveProvider``'s healthy rows and a PCA detector (per
            model, K1), served with ``GORDO_STREAM=1``, ``GORDO_PUSH=1`` and
            ``GORDO_BANK_DTYPE=int8``; windows over JSON, the tensor wire
            and ``Client.ingest``; ``/drift`` flags nothing, then exactly
            the 4 members whose windows carry a mean shift; ``/adapt``
            recalibrates and then refits them, each under a concurrent
            scoring loop (a new generation each, no answer but 200); two
            ``PushSubscriber`` loops receive their scored windows; ingest
            rows/s, the sweeps' seconds, the adaptations' walls and
            ``pause_ms``, launches;
    gang    gang worker threads, the member-width cap, the staging engines
            and the profiler: six 4-machine gangs (10 tags, 1,008 rows, 2
            epochs: dense, variational, conv, lstm_hourglass at lookbacks
            10, 12, 16; two dense machines at 7 min with the median) built
            at ``GORDO_GANG_WIDTH`` 1, 4, 1, 4 and at 4 with
            ``GORDO_LOAD_MODE=process``: artifacts bitwise where the two
            width-1 builds are, else within the training bands,
            ``gang_width`` in the report and ``build_trace.json``, a
            ``fit:`` span every group, models/hour and walls; the
            ``GORDO_FLEET_WIDTH=auto`` sweep (once, then from its cache) and
            the train phase's fleet capped at 256 and not; under
            ``GORDO_PROFILE_DIR`` one LSTM gang fit and several traced bank
            groups, every capture holding a kernel for each launch after
            its lead-in (K3 in the fit, K2 and K3 in each group; the
            lead-in launches it lost are printed), and ``device_execute``
            carrying ``profile``;
    replay  the replay harness: ``default_fleet()`` (4 members, 3 and 5
            tags, 3 epochs) trained with ``replay.engine.train_fleet`` on the
            card, then the eight ``standard_scenarios()`` through one
            ``ReplayEngine`` at the JAX defaults (speed 500, 24-row batches,
            128-row windows), each over a fresh server on a replay clock:
            every verdict passes its scenario's ``judge`` whole (the 100x
            speed floor included) with no answer but 200, the refit fault
            scenario records its rollback; each scenario's wall, speedup,
            detection latency, adaptation and refit seconds, the swap's
            pause, FP rates before and after, K2 launches and the
            ``gordo_replay_*`` series. The cli phase also runs ``workflow
            compile`` twice (byte-equal DAGs) and ``workflow generate``;
    watchman  the watchman's read side over three one-card replicas:
            ``run-server`` subprocesses (``GORDO_STREAM=1``) over 6 dense and
            2 ``lstm_hourglass`` detectors each (10 tags, lookback 32; 24
            members, none on two), the watchman in this process on a replay
            clock. ``GET /`` (replica 0's members, each healthy and banked,
            three reachable replicas) and a snapshot of each other replica;
            ``/routing`` every member at its owner, a routed ``Client``
            bitwise the owners' direct answers (one chunk at a time);
            ``/metrics``' summed request counters the replicas' own; the
            ``/traces``, ``/slo``, ``/heat``, ``/costs``, ``/history`` and
            ``/events`` parts of each replica its own endpoint's; a mean
            shift flagged in exactly 2 members by ``/drift?refresh=1`` and
            ``/`` degraded; ``watchman.scrape``, ``.snapshot`` and
            ``.probe`` armed (last good numbers, a stale snapshot, the
            replicas dark then recovered with their events); a replica
            SIGTERMed (unreachable, its members unhealthy, its counters
            frozen and stamped stale); ``run-watchman`` of the CLI. The
            snapshot's, the scrapes', the routing build's and the drift
            sweep's walls and the routed rows/s; the replicas' launches;
    workflow  the rollout's run side: ``workflow run`` of the CLI (the
            fleet executor) over two counted ``run-server`` replicas on the
            card, each over a collection of its own seeded with the
            incumbent (a plan-only run of the same spec), the spec
            examples/fleet.yaml plus a game-day gate
            (``replica_crash_restart``, ``gray_failure_slow_replica``) and
            a ``rev`` a machine; a thread scores every member through the
            tensor wire throughout. Promote (every step executed, the gate
            passed, the served ``rev`` the new one on each replica's
            members), an edit of one machine (only its build, its bucket
            and the rollout tail executed), and a ``workflow.canary`` fault
            in the executor's process (``fleet.rollback``, the incumbent
            served again, bitwise its answers before the run); no answer
            but 200 in any run. Each run's wall, the verdicts, the gate's
            drill walls, every landing's ``pause_ms``, the launches;
    gameday  ``run_gameday`` over the whole catalog: seven scenarios on
            five mesh shapes, every replica a counted
            ``gameday/replica.py`` child on the card and the watchman in
            this process; each scenario passed by its own judge, the
            document of ``GAMEDAY_SCHEMA``. Each scenario's wall, detection
            seconds, answers other than 200 and the replicas' start times;
13. counts  the main-path wrappers' launch counters of every path (train,
            seq_train, seq_fleet, zoo_train, zoo_fleet, bf16_train, http,
            bank, lstm, zoo_bank, bf16_bank, build, cli, cv, collection, lake,
            definitions, observe, pipeline, qos, wire, client, resilience,
            quantized, stream, gang, replay, watchman, placement, mesh,
            workflow, gameday), each reset just
            before its path and read just after; each kernel's total must be
            above 0 (K3's bf16 instance counted as its own kernel), K1 and K2
            above 0 on the config-4 paths, K3-bf16 on bf16_train and
            bf16_bank, K1 on bf16_train and K2 on bf16_bank.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA. Weights and data are random, made from fixed seeds.

    python3 chip_smoke.py PHASE [PHASE ...]      (e.g. gang)

runs only the named paths and checks (after the kernels' build), each
path's launch counts from 0 and held to its kernels as in the whole run,
then its counts and walls; the kernels' parity and numbers are the whole
run's.

The whole run drives the paths in three processes of this script at once:
after the kernels' checks it starts two more (``--lane``), each over the
paths of one of LANES, which it runs one after another while this process
runs the rest; it joins them before the ``workflow`` step, whose canary and
game-day judges read latency, and prints their lines then. Each path still
counts its launches from 0 in the process that drives it, and every kernel
shape the lanes' paths gave joins this process's for ``path_parity``. The
paths' walls and rates are read beside the other lanes' work.
"""

import asyncio
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import datetime
import functools
import gc
import gzip
import hashlib
import http.client
import io
import http.server
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gordo_components_torch import resolve_device, serializer
from gordo_components_torch.builder import (
    build_fleet,
    build_model,
    calculate_model_key,
    fleet_build,
    provide_saved_model,
)
from gordo_components_torch.cli import main as cli_main
from gordo_components_torch.client import Client
from gordo_components_torch.convert import entry_from_numpy, lstm_to_flax, params_to_flax
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.dataset.data_provider._parquet import read_parquet, read_parquet_bytes
from gordo_components_torch.dataset.times import isoformat, to_ns
from gordo_components_torch.models import (
    AutoEncoder,
    ConvAutoEncoder,
    DiffBasedAnomalyDetector,
    LSTMAutoEncoder,
    lookup_factory,
    train_core,
)
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.observability.metrics import MetricsRegistry, parse_prometheus_text
from gordo_components_torch.ops import _cuda, score, seq_scan
from gordo_components_torch.parallel import FleetTrainer, quantize_batch_count
from gordo_components_torch.resilience.deadline import Deadline, DeadlineExceeded
from gordo_components_torch.server import BatchingEngine, ModelBank, run_server
from gordo_components_torch.server.model_io import ModelCollection
from gordo_components_torch.utils.shm_ring import ShmRingClient
from gordo_components_torch.utils.wire import ANOMALY_FRAME_NAMES, TENSOR_CONTENT_TYPE, pack_frames, unpack_frames
from gordo_components_torch.utils.yaml_subset import safe_load
from gordo_components_torch.workflow import DEFAULT_MODEL_CONFIG, Machine

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(ROOT, "build", "chip_smoke_models")
FLEET_DIR = os.path.join(ROOT, "build", "chip_smoke_fleet")
CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
CV_DIR = os.path.join(ROOT, "build", "chip_smoke_cv")
FLEET_YAML = os.path.join(ROOT, "examples", "fleet.yaml")
CLI_TIMEOUT_S = 600  # the deadline of each CLI subprocess
CLI_DEVICE = "cuda"
# the cv phase: dense and LSTM machines of the reference's widths, each
# cross-validated over 3 folds in its gang
CV_MEMBERS = dict(dense=16, lstm=4)  # cut from 64 and 8, then 32 dense (the smoke's wall)
CV_LSTM_EPOCHS = 3  # the LSTM machines' epochs, cut from the estimator's 10 (the smoke's wall)
CV_EVALUATION = {"cross_validation": True, "n_splits": 3}
# the reference bench's fleet (bench.py bench_fleet; BASELINE.json config 3)
FLEET_SHAPE = dict(n_models=1024, rows=1440, n_features=10)
FLEET_CONFIG = dict(kind="feedforward_hourglass", epochs=5, batch_size=128)
# card vs CPU after three Adam steps from the same parameters: the band
# tests/test_torch_fleet.py holds the port's FleetTrainer to against JAX's
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NORM_RTOL = NORM_ATOL = 1e-6  # the JAX package's band for the two norms
E2E_ATOL = 1e-5  # card vs CPU: matmul accumulation order and tanh differ in the last bits
# LSTM card vs CPU: the JAX suite's band for the time-major scan against the
# per-member layout (tests/test_seq_fastpath.py)
LSTM_RTOL, LSTM_ATOL = 1e-4, 1e-5
STEP_RTOL = STEP_ATOL = 1e-6  # one fused LSTM step (the JAX suite's band)
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6  # 32 chained steps (ditto)
SERVE_SHAPE = (64, 64, 10, 10000)  # B, T, F, M of a full coalesced batch
RAGGED = [(3, 261, 130, 5), (1, 7, 3, 1), (8, 16, 257, 16)]
K2_LSTM_SHAPE = (64, 97, 10, 10000)  # the LSTM bank's full batch: 97 scored rows a slot
# K2's packed result: the serving shapes and ragged ones, one slot of
# max_rows_per_call rows, a slot width (3*T*F + 2*T = 77) that is not a
# multiple of 4, and lane groups on both sides of each power of two up to 32
# (and past a warp), at 64 and 97 rows
K2_SHAPES = ([SERVE_SHAPE, K2_LSTM_SHAPE, *RAGGED, (1, 8192, 10, 1), (5, 7, 3, 4)]
             + [(4, n, f, 6) for f in (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 130)
                for n in (64, 97)])
LOOKBACK = 32
# the reference bench's config 2 (bench.py bench_sequence_models) in float32,
# 5 epochs; as a fleet at the bench's fleet width
SEQ_CONFIG = dict(kind="lstm_hourglass", lookback_window=LOOKBACK, batch_size=128)
SEQ_EPOCHS = 5
SEQ_CHECK_EPOCHS = 2  # seq_train's detector and validated fits (their K3 checks), cut from 5
SEQ_FLEET_MEMBERS = 256  # cut from 1,024, then 512 (the smoke's wall)
QUANTILE_BINS = 8192  # the sequence error pass's histogram bins
# (S, B, M, H) of the LSTM bank's full batch: 32 steps, 97 windows of a
# 128-row request, 64 slots, the widest hourglass layer; then ragged shapes
LSTM_SERVE = (LOOKBACK, 97, 64, 8)
LSTM_RAGGED = [(LOOKBACK, 1, 1, 5), (LOOKBACK, 3, 7, 37), (LOOKBACK, 200, 1, 64),
               (LOOKBACK, 3, 7, 130), (LOOKBACK, 1, 7, 512), (LOOKBACK, 200, 7, 512)]
# the edges of K3's design: lane groups of next_pow2(H) up to H = 32 (warp
# path), the block path from H = 33; S = 1, 5 and 33 steps (33 passes the
# 8-slot ring several times); 97 windows of one member
LSTM_EDGES = [(S, B, M, H) for H in (7, 16, 31, 32, 33)
              for S, B, M in ((1, 3, 5), (5, 2, 3), (33, 97, 1))]
# the shapes training and building give K3: seq_fleet's error passes (a
# batch of 128 windows of 1,024 members, every hourglass width), seq_train's
# validation batches and its detector's predict (128 and 1,409 windows of
# one member), and the build's gangs and single builds (lookbacks 10, 12 and
# 16, batch 100, 4 and 2 members; turbine-lstm's widths 2 and 1 at 2 tags; a
# bespoke detector's predict over 992 windows), and the cv phase's: the LSTM
# gang's error passes (batch 100, 8 members), its fold scoring and the single
# build's (221 windows of a 252-row test block), and the single build's fold
# error passes (473 and 725 windows)
LSTM_TRAIN = ([(LOOKBACK, 128, 1024, H) for H in (8, 7, 5)]
              + [(LOOKBACK, 128, 1, 8), (LOOKBACK, 1409, 1, 8), (10, 100, 4, 8), (10, 100, 2, 7),
                 (12, 100, 4, 8), (12, 100, 1, 2), (12, 100, 1, 1), (16, 992, 1, 5)]
              + [(LOOKBACK, B, M, H) for B, M in ((100, 8), (221, 1), (473, 1), (725, 1))
                 for H in (8, 7, 5)])
HOURGLASS_WIDTHS = (8, 7, 5, 5, 7, 8)  # lstm_hourglass's layers at 10 tags
# the reference bench's config 4 (bench.py bench_sequence_models) in float32:
# the conv autoencoder at lookback 32 and the variational one, default widths
ZOO_MODELS = {
    "conv": (ConvAutoEncoder, dict(lookback_window=LOOKBACK)),
    "vae": (AutoEncoder, dict(kind="feedforward_variational")),
}
ZOO_EPOCHS = 5
# config 4 as a fleet (bench.py _FLEET_FAMILIES, _family_fleet_metric)
ZOO_FLEET = dict(n_models=256, rows=720, n_features=10)
ZOO_FLEET_MODELS = {
    "conv": dict(model_type="ConvAutoEncoder", channels=(16, 8), lookback_window=LOOKBACK),
    "vae": dict(kind="feedforward_variational", dims=(64,), latent_dim=8),
}
ZOO_FLEET_CONFIG = dict(epochs=3, batch_size=128, host_sync_every=3)
KERNELS = {
    "banked_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:298",
    "fused_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:84",
    "lstm_layer": "gordo_components_tpu/ops/seq_scan.py:218",
    "lstm_layer_bf16": "gordo_components_tpu/ops/seq_scan.py:218",
}
BF16 = "bfloat16"
# a bfloat16 model's arrays on the card against the CPU's: the JAX suite's
# bfloat16 band (tests/test_conv_impl.py:38-57), 2e-2 * max(1, |x|)
BF16_ATOL = 2e-2
# K3's bfloat16 instance against its bfloat16 plain version on the card:
# (least share of values bitwise equal, most error in bfloat16 ulps of the
# plain result's largest |value|). h and c are float32, but every gate is
# rounded to bfloat16, so a rounding that falls the other way moves a value
# by about one such ulp. The kernel sums a gate's H products in another
# order than cuBLAS does, so now and then a rounding falls the other way,
# and within a layer the recurrence carries it on through the window. From
# readings on an NVIDIA H100 80GB HBM3 at 700.00 W with the seeds below
# (PERF.md, section 6): a step kept at least 0.99972 bitwise and 0.853 ulps
# at every shape; a layer at least 0.99991 and 0.021 ulps at every shape
# but three wide ones (0.9975, 0.9446 and 0.9095 there, 1.836 ulps at most).
# The control, the fp32 instance on the same inputs cast up to float32 (a
# kernel that skips every bfloat16 rounding), kept at most 3.3e-4 bitwise at
# 0.27-2.9 ulps: the shares tell the two apart, the errors alone do not
K3_BF16_STEP = (0.999, 1.0)
K3_BF16_LAYER = (0.999, 2.0)
K3_BF16_LAYER_WIDE = {(LOOKBACK, 200, 1, 64): 0.99, (LOOKBACK, 1, 7, 512): 0.9,
                      (LOOKBACK, 200, 7, 512): 0.85}
# a bf16 bank's model output on the card against the CPU's, each held
# request: (least share bitwise, most error in bf16 ulps of its largest
# |value|). On an NVIDIA H100 80GB HBM3 at 700.00 W the smoke read the
# dense bank bitwise and the LSTM bank at least 0.9876 bitwise, 1 ulp off
# at most (K3's flips, above, carried through the head)
BF16_BANK_VS_CPU = {"dense": (0.999, 1.0), "lstm": (0.98, 2.0)}
# odd B*M*H: every other bfloat16 step starts 8 bytes off a 16-byte line
# (lstm_hourglass's H = 5 and 7 for one member's 97 windows)
BF16_MISALIGNED = [(LOOKBACK, 97, 1, 5), (LOOKBACK, 97, 1, 7)]
# the float32 phases' numbers, printed beside the bfloat16 phases'
F32_RUNS = {}
SOURCE = "gordo_components_torch/ops/csrc/anomaly_score.cu"
K1_TURNS = 100  # rounds of K1 against its library call, one call of each a round
# the shapes every call on the card gave each kernel from the main paths on,
# this process's and the CLI runs': K1's (rows, F), K2's (B, T, F, M), K3's
# (S, B, M, H); held against the plain versions afterwards
PATH_SHAPES = {name: set() for name in KERNELS}
LSTM_SOURCE = "gordo_components_torch/ops/csrc/lstm_step.cu"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def resource_usage(libs) -> dict:
    """library -> (kernels, most registers a thread, most local-memory
    bytes a thread: spills) from ``cuobjdump --dump-resource-usage``, or
    "not measured" where the tool or its output is missing."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    out = {name: "not measured" for name in libs}
    if not os.path.exists(cuobjdump):
        return out
    for name, lib in sorted(libs.items()):
        proc = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib)],
                              capture_output=True, text=True, timeout=120)
        use = [(int(r), int(l)) for r, l in re.findall(r"REG:(\d+) .*?LOCAL:(\d+)", proc.stdout)]
        out[name] = ((len(use), max(r for r, _ in use), max(l for _, l in use)) if use
                     else "not measured")
    return out


def card_clocks() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ #
# phase 3: kernels against their plain versions
# ------------------------------------------------------------------ #


def make_case(B, T, F, M, seed):
    g = torch.Generator().manual_seed(seed)
    target = torch.randn(B, T, F, generator=g)
    output = target + 0.1 * torch.randn(B, T, F, generator=g)
    shift = 0.01 * torch.randn(M, F, generator=g)
    scale = 1.0 + torch.rand(M, F, generator=g)
    idx = torch.randint(0, M, (B,), generator=g, dtype=torch.int32)
    return [a.cuda() for a in (target, output, shift, scale, idx)]


def compare(got, want, what: str) -> float:
    for g, w, name in zip(got[:2], want[:2], ("diff", "scaled")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} is not bitwise equal to the plain version")
    err = 0.0
    for g, w, name in zip(got[2:], want[2:], ("tot_u", "tot_s")):
        if not torch.allclose(g, w, rtol=NORM_RTOL, atol=NORM_ATOL):
            raise AssertionError(f"{what}: {name} outside rtol=atol=1e-6")
        err = max(err, float((g - w).abs().max()))
    return err


def library_banked(target, output, shift_bank, scale_bank, idx):
    """The epilogue as one PyTorch expression (yardstick only)."""
    diff = (target - output).abs()
    scaled = (diff - shift_bank[idx.long()][:, None]) * scale_bank[idx.long()][:, None]
    return diff, scaled, torch.linalg.vector_norm(diff, dim=-1), torch.linalg.vector_norm(scaled, dim=-1)


def library_fused(target, output, shift, scale):
    diff = (target - output).abs()
    scaled = (diff - shift) * scale
    return diff, scaled, torch.linalg.vector_norm(diff, dim=-1), torch.linalg.vector_norm(scaled, dim=-1)


def packed_plain(target, output, shift_bank, scale_bank, idx):
    """The banked epilogue's packed result from its plain version."""
    B = target.shape[0]
    plain = score.banked_score_plain(target, output, shift_bank, scale_bank, idx)
    return torch.cat([a.reshape(B, -1) for a in (output, *plain)], dim=1)


def library_packed(target, output, shift_bank, scale_bank, idx):
    """The packed result as one PyTorch expression and a cat (yardstick
    only)."""
    B = target.shape[0]
    parts = library_banked(target, output, shift_bank, scale_bank, idx)
    return torch.cat([a.reshape(B, -1) for a in (output, *parts)], dim=1)


def compare_packed(buf, args, what: str) -> float:
    """The packed result against the plain version: the output copy, diff
    and scaled bitwise, the norms within rtol=atol=1e-6."""
    target, output = args[:2]
    B, T, F = target.shape
    if buf.shape != (B, 3 * T * F + 2 * T):
        raise AssertionError(f"{what}: packed shape {tuple(buf.shape)}")
    copy, *got = score.unpack_banked(buf, T, F)
    if not torch.equal(copy, output):
        raise AssertionError(f"{what}: the output copy is not bitwise equal to the output")
    return compare(got, score.banked_score_plain(*args), what)


def host_us(fn, n=1000) -> float:
    """Mean host time of one call, perf_counter_ns over n calls."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    us = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(us, 3)


def host_split(pieces) -> dict:
    """Where a wrapper's host time goes: each piece timed alone
    (perf_counter_ns over 1,000 calls each)."""
    return {k: host_us(f) for k, f in pieces.items()}


def k1_pieces(single):
    tgt, out, sh, sc = single
    rows, F = tgt.shape
    dev, f32, index = tgt.device, torch.float32, tgt.get_device()
    buf = torch.empty(2 * rows * (F + 1), dtype=f32, device=dev)
    stream, one, counts = torch.cuda.current_stream(dev).cuda_stream, score._one(), _cuda.LaunchCounts("k")
    plan = score._launch_plan(rows, F)
    return {
        "checks_x4": lambda: [t.shape != w or t.dtype != f32 or t.device != dev
                              or not t.is_contiguous() for t, w in (
                                  (tgt, tgt.shape), (out, tgt.shape), (sh, (F,)), (sc, (F,)))],
        "empty_x1": lambda: torch.empty(2 * rows * (F + 1), dtype=f32, device=dev),
        "plan_lookup": lambda: score._launch_plan(rows, F),
        "stream_of_index": lambda: torch.cuda.current_stream(index).cuda_stream,
        "ctypes_launch_11_args": lambda: one(tgt.data_ptr(), out.data_ptr(), sh.data_ptr(),
                                             sc.data_ptr(), rows, F, *plan, buf.data_ptr(), stream),
        "launch_counter": lambda: counts.add("k"),
        "unpack_views": lambda: score.unpack_scores(buf, rows, F),
        "whole": lambda: score.fused_anomaly_score(*single),
    }


def k2_pieces(args):
    tgt, out, sh, sc, ix = args
    B, T, F = tgt.shape
    M = sh.shape[0]
    dev, f32, index = tgt.device, torch.float32, tgt.get_device()
    buf = torch.empty((B, 3 * T * F + 2 * T), dtype=f32, device=dev)
    stream, banked = torch.cuda.current_stream(dev).cuda_stream, score._banked()
    counts = _cuda.LaunchCounts("k")
    plan = score._launch_plan(T, F)
    return {
        "checks_x5": lambda: [t.shape != w or t.dtype != d or t.device != dev
                              or not t.is_contiguous() for t, d, w in (
                                  (tgt, f32, tgt.shape), (out, f32, tgt.shape), (sh, f32, (M, F)),
                                  (sc, f32, (M, F)), (ix, torch.int32, (B,)))],
        "empty_x1": lambda: torch.empty((B, 3 * T * F + 2 * T), dtype=f32, device=dev),
        "plan_lookup": lambda: score._launch_plan(T, F),
        "stream_of_index": lambda: torch.cuda.current_stream(index).cuda_stream,
        "ctypes_launch_13_args": lambda: banked(
            tgt.data_ptr(), out.data_ptr(), sh.data_ptr(), sc.data_ptr(), ix.data_ptr(), B, T, F,
            *plan, buf.data_ptr(), stream),
        "launch_counter": lambda: counts.add("k"),
        "whole": lambda: score.banked_anomaly_score_packed(*args),
    }


def device_ops_per_call(fn, args, runs=50) -> float:
    """Device operations (kernels, fills, copies) per call, from the
    profiler's trace of ``runs`` calls."""
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    events, _, _ = device_trace(lambda: [fn(*args) for _ in range(runs)],
                                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return len(events) / runs


def time_ms(fn, args, warmup=20, runs=100) -> float:
    """Median over ``runs`` calls of CUDA-event time around one call."""
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def alternating_ms(fns, args, rounds=K1_TURNS, warmup=10):
    """Median CUDA-event ms a call of each function on the same arguments,
    the calls taken in turns (one of each a round)."""
    for _ in range(warmup):
        for fn in fns:
            fn(*args)
    events = [[] for _ in fns]
    for _ in range(rounds):
        for fn, got in zip(fns, events):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            got.append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in got) for got in events]


def kernel_device_us(fn, args, runs=50, kernel="score_rows", attempts=2):
    """Average device time of the named CUDA kernel itself, from the
    profiler's CUDA trace; a trace that holds no device time for it (the
    profiler can drop a trace's device events) is taken again, and None is
    returned when every attempt's trace lacks it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn(*args)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if kernel in evt.key:
                us = getattr(evt, "device_time", None) or getattr(evt, "cuda_time", None)
                if us:
                    return round(us, 3)
    return None


def bound_ms(B, T, F, idx=None) -> float:
    """Least time for the epilogue on this card: every input byte read once
    and every output byte written once, against ~8 float32 operations per
    element. Banked (idx given): target, output, idx and the scaler rows
    this idx gathers in, the packed result (output copy, diff, scaled, two
    norms) out; per model (idx None): target, output and one scaler row
    pair in, diff, scaled and the norms out."""
    if idx is None:
        moved = 4 * (2 * T * F + 2 * F) + 4 * (2 * T * F + 2 * T)
    else:
        rows = len(torch.unique(idx))
        moved = 4 * (2 * B * T * F + B + 2 * rows * F) + 4 * (3 * B * T * F + 2 * B * T)
    ops = 8 * B * T * F + 2 * B * T
    return max(moved / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3


def kernel_phase():
    results = {}
    B, T, F, M = SERVE_SHAPE
    # K2: the packed result at every shape of K2_SHAPES
    err = 0.0
    for i, shape in enumerate(K2_SHAPES):
        args = make_case(*shape, seed=i)
        buf = score.banked_anomaly_score_packed(*args)
        torch.cuda.synchronize()
        err = max(err, compare_packed(buf, args, "banked {}x{}x{}x{}".format(*shape)))
    args = make_case(B, T, F, M, seed=99)
    bound = bound_ms(B, T, F, args[4])
    k2 = results["banked_anomaly_score"] = {
        "name": "banked_anomaly_score", "route": "cuda", "source": SOURCE,
        "replaces": KERNELS["banked_anomaly_score"], "launches": None, "max_abs_err": err,
        "ms": time_ms(score.banked_anomaly_score_packed, args),
        "plain_ms": time_ms(packed_plain, args), "bound_ms": bound, "bound_by": "bytes",
        "library_ms": time_ms(library_packed, args),
    }
    ops = device_ops_per_call(score.banked_anomaly_score_packed, args)
    # at most one device operation a call (the profiler may drop an event,
    # never add one)
    if ops > 1.0:
        raise AssertionError(f"banked_anomaly_score makes {ops} device operations a call, more than 1")
    lstm_args = make_case(*K2_LSTM_SHAPE, seed=98)
    phase("parity", kernel="banked_anomaly_score", shapes=len(K2_SHAPES),
          bitwise="output_copy,diff,scaled", max_norm_err=err,
          kernel_device_us=kernel_device_us(score.banked_anomaly_score_packed, args),
          lstm_shape_device_us=kernel_device_us(score.banked_anomaly_score_packed, lstm_args),
          lstm_shape_bound_us=round(bound_ms(*K2_LSTM_SHAPE[:3], lstm_args[4]) * 1e3, 4),
          floor_us=kernel_device_us(score.banked_anomaly_score_packed, make_case(1, 1, F, 1, seed=97)),
          device_ops_per_call=ops, ms=round(k2["ms"], 5), plain_ms=round(k2["plain_ms"], 5),
          library_ms=round(k2["library_ms"], 5), below_library=k2["ms"] < k2["library_ms"],
          bound_ms=round(bound, 6), host_us=json.dumps(host_split(k2_pieces(args))))
    # K1: one detector's request at the serving shapes, then ragged ones
    err = 0.0
    for i, (b, t, f, m) in enumerate([SERVE_SHAPE, *RAGGED]):
        tgt, out, sh, sc, ix = make_case(b, t, f, m, seed=i)
        m0 = int(ix[0])
        single = (tgt[0].contiguous(), out[0].contiguous(), sh[m0].contiguous(), sc[m0].contiguous())
        got = score.fused_anomaly_score(*single)
        torch.cuda.synchronize()
        err = max(err, compare(got, score.score_plain(*single), f"fused {t}x{f}"))
    tgt, out, sh, sc, ix = args
    single = (tgt[0].contiguous(), out[0].contiguous(), sh[int(ix[0])].contiguous(),
              sc[int(ix[0])].contiguous())
    bound = bound_ms(1, T, F)
    k1 = results["fused_anomaly_score"] = {
        "name": "fused_anomaly_score", "route": "cuda", "source": SOURCE,
        "replaces": KERNELS["fused_anomaly_score"], "launches": None, "max_abs_err": err,
        "ms": time_ms(score.fused_anomaly_score, single),
        "plain_ms": time_ms(score.score_plain, single), "bound_ms": bound, "bound_by": "bytes",
        "library_ms": time_ms(library_fused, single),
    }
    ops = device_ops_per_call(score.fused_anomaly_score, single)
    if ops > 1.0:
        raise AssertionError(f"fused_anomaly_score makes {ops} device operations a call, more than 1")
    phase("parity", kernel="fused_anomaly_score", shapes=1 + len(RAGGED), bitwise="diff,scaled",
          max_norm_err=err, kernel_device_us=kernel_device_us(score.fused_anomaly_score, single),
          device_ops_per_call=ops, ms=round(k1["ms"], 5), plain_ms=round(k1["plain_ms"], 5),
          library_ms=round(k1["library_ms"], 5), below_library=k1["ms"] < k1["library_ms"],
          bound_ms=round(bound, 7), host_us=json.dumps(host_split(k1_pieces(single))))
    turn_ms, turn_library_ms = alternating_ms((score.fused_anomaly_score, library_fused), single)
    phase("parity", kernel="fused_anomaly_score", in_turns=f"{K1_TURNS} rounds of (kernel, library) at {T}x{F}",
          ms_median=round(turn_ms, 6), library_ms_median=round(turn_library_ms, 6),
          below_library=turn_ms < turn_library_ms)
    seen = nonfinite_parity()
    phase("parity", kernels="banked_anomaly_score,fused_anomaly_score", nonfinite="nan,+inf,-inf",
          placed_in="output,target,one member's scale row", shapes="K2 64x64x10 M=10000, K1 64x10",
          held="NaN and +-inf elementwise, finite copy/diff/scaled bitwise, finite norms rtol=atol=1e-6",
          nonfinite_totals=json.dumps(seen))
    return results


NONFINITE = {"nan": float("nan"), "+inf": float("inf"), "-inf": float("-inf")}


def nonfinite_case(where: str, value: float, seed: int):
    """make_case at the serving shape with ``value`` in 64 random elements
    of ``output`` or ``target``, or in the whole scale row of the member
    the first slot reads."""
    args = make_case(*SERVE_SHAPE, seed=seed)
    if where == "scale":
        args[3][int(args[4][0])] = value
    else:
        arr = args[0 if where == "target" else 1].view(-1)
        g = torch.Generator().manual_seed(seed)
        arr[torch.randperm(arr.numel(), generator=g)[:64].cuda()] = value
    return args


def same_nonfinite(got, want, what: str, exact: bool) -> None:
    """NaN where the plain version has NaN, the same infinities by sign,
    and the finite elements bitwise (``exact``) or within the norms' band."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, not {tuple(want.shape)}")
    for mask, name in ((torch.isnan, "NaN"), (torch.isposinf, "+inf"), (torch.isneginf, "-inf")):
        if not torch.equal(mask(got), mask(want)):
            raise AssertionError(f"{what}: its {name} elements are not the plain version's")
    fin = torch.isfinite(want)
    if exact and not torch.equal(got[fin], want[fin]):
        raise AssertionError(f"{what}: a finite element is not bitwise equal to the plain version")
    if not exact and not torch.allclose(got[fin], want[fin], rtol=NORM_RTOL, atol=NORM_ATOL):
        raise AssertionError(f"{what}: a finite norm outside rtol=atol=1e-6")


def nonfinite_parity() -> dict:
    """K2's packed result and K1's four outputs against their plain
    versions with NaN, +inf and -inf in ``output``, in ``target`` and in one
    member's scale row, at the serving shapes (K2 (64, 64, 10, 10000), K1 a
    64x10 request): the breaker reads the kernel's totals, so a kernel that
    dropped a NaN would hide a poisoned model. Returns how many of each
    kernel's totals came out non-finite."""
    B, T, F, M = SERVE_SHAPE
    seen = {"banked_anomaly_score": 0, "fused_anomaly_score": 0}
    for i, (where, (label, value)) in enumerate(
            (w, v) for w in ("output", "target", "scale") for v in NONFINITE.items()):
        args = nonfinite_case(where, value, seed=200 + i)
        what = f"non-finite {label} in {where}"
        buf = score.banked_anomaly_score_packed(*args)
        torch.cuda.synchronize()
        want = packed_plain(*args)
        got_parts, want_parts = score.unpack_banked(buf, T, F), score.unpack_banked(want, T, F)
        for g, w, name, exact in zip(got_parts, want_parts, ("copy", "diff", "scaled", "tot_u", "tot_s"),
                                     (True, True, True, False, False)):
            same_nonfinite(g, w, f"banked {what}: {name}", exact)
        seen["banked_anomaly_score"] += int((~torch.isfinite(got_parts[4])).sum())
        tgt, out, sh, sc, ix = args
        m0 = int(ix[0])
        single = (tgt[0].contiguous(), out[0].contiguous(), sh[m0].contiguous(), sc[m0].contiguous())
        got = score.fused_anomaly_score(*single)
        torch.cuda.synchronize()
        for g, w, name, exact in zip(got, score.score_plain(*single), ("diff", "scaled", "tot_u", "tot_s"),
                                     (True, True, False, False)):
            same_nonfinite(g, w, f"fused {what}: {name}", exact)
        seen["fused_anomaly_score"] += int((~torch.isfinite(got[3])).sum())
    if min(seen.values()) <= 0:
        raise AssertionError(f"non-finite parity: no non-finite total came out: {seen}")
    return seen


def lstm_case(S, B, M, H, seed):
    """Inputs of S LSTM steps at the scale of a fitted stack: xz (S, B, M,
    4H), h, c (B, M, H), Wh (M, H, 4H) with columns of unit variance, b
    (M, 4H)."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn(S, B, M, 4 * H, generator=g)
    h = torch.tanh(torch.randn(B, M, H, generator=g))
    c = torch.randn(B, M, H, generator=g)
    Wh = torch.randn(M, H, 4 * H, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(M, 4 * H, generator=g)
    return [a.cuda() for a in (xz, h, c, Wh, b)]


def library_step(xz_t, h, c, Wh, b):
    """One step as one torch.baddbmm plus the gate expression (yardstick
    only), in the (M, B, .) layout baddbmm wants, in the dtype of xz, Wh
    and b (h and c float32)."""
    z = torch.baddbmm(xz_t.transpose(0, 1), h.transpose(0, 1).to(Wh.dtype), Wh) + b[:, None, :]
    i, f, g, o = z.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c.transpose(0, 1) + torch.sigmoid(i) * torch.tanh(g)
    return c2.transpose(0, 1), (torch.sigmoid(o) * torch.tanh(c2)).transpose(0, 1)


def library_layer(xz, Wh, b):
    """A layer as S library steps from a zero state (yardstick only)."""
    S, B, M, H4 = xz.shape
    h = c = torch.zeros((B, M, H4 // 4), device=xz.device)
    ys = []
    for t in range(S):
        c, h = library_step(xz[t], h, c, Wh, b)
        ys.append(h)
    return torch.stack(ys)


def lstm_bound(S, B, M, H, elem_bytes=4):
    """Least time for S fused steps on this card, and what bounds it: xz, Wh
    and b (``elem_bytes`` an element: 4 float32, 2 bfloat16) read once,
    every step's h and the final c (float32) written once; per (step,
    window, member) 8H^2 operations for the product, 8H for the two
    additions and about 24H for the gates and the carry update, all float32
    arithmetic in both instances."""
    moved = (elem_bytes * (S * B * M * 4 * H + M * H * 4 * H + M * 4 * H)
             + 4 * (S * B * M * H + B * M * H))
    ops = S * B * M * (8 * H * H + 32 * H)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def close(got, want, rtol, atol, what) -> float:
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"{what}: outside rtol={rtol}, atol={atol} (max err {err})")
    return float((got - want).abs().max())


def bf16_self_tests():
    """K3-bf16's self-tests on the card, each required to find 0
    mismatches: every one of the 65,536 codes through the gate tables'
    path against the cell's formula (sigmoid, tanh), and the packed
    bfloat16 add and multiply against float32-then-round over all 2^32
    pairs of codes, the packed conversion over all 2^32 float32 values."""
    lib, p = _cuda.load("lstm_step"), ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    gate = torch.zeros(2, dtype=torch.int32, device="cuda")
    arith = torch.zeros(3, dtype=torch.int32, device="cuda")
    tables = seq_scan.gate_tables(torch.device("cuda"))
    for entry, args in (("gordo_lstm_bf16_gate_check", (tables.data_ptr(), gate.data_ptr())),
                        ("gordo_lstm_bf16_arith_check", (arith.data_ptr(),))):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [p] * (len(args) + 1), ctypes.c_int
        if fn(*args, stream) != 0:
            raise RuntimeError(f"{entry} did not launch")
    torch.cuda.synchronize()
    gate = dict(zip(("sigmoid", "tanh"), gate.tolist()))
    arith = dict(zip(("add", "mul", "cvt"), arith.tolist()))
    if any(gate.values()) or any(arith.values()):
        raise AssertionError(f"bf16 self-tests: gate tables {gate}, packed arithmetic {arith} mismatches")
    return gate, arith


def lstm_kernel_phase():
    """K3 against its plain versions: one step (fused_lstm_step, S=1) and a
    whole layer (lstm_layer, S steps) at every shape, the serving, edge and
    training shapes; times at the bank's."""
    resolve_device("cuda")  # full float32 products for the plain versions
    step_err = layer_err = 0.0
    shapes = [LSTM_SERVE, *LSTM_RAGGED, *LSTM_EDGES, *LSTM_TRAIN]
    for i, (S, B, M, H) in enumerate(shapes):
        xz, h, c, Wh, b = lstm_case(S, B, M, H, seed=100 + i)
        got = seq_scan.fused_lstm_step(xz[0], h, c, Wh, b)
        torch.cuda.synchronize()
        want = seq_scan.lstm_step_plain(xz[0], h, c, Wh, b)
        for g, w, name in zip(got, want, ("c", "h")):
            step_err = max(step_err, close(g, w, STEP_RTOL, STEP_ATOL,
                                           f"fused_lstm_step {name} B={B} M={M} H={H}"))
        got = seq_scan.lstm_layer(xz, Wh, b)
        torch.cuda.synchronize()
        layer_err = max(layer_err, close(got, seq_scan.lstm_layer_plain(xz, Wh, b), LAYER_RTOL,
                                         LAYER_ATOL, f"lstm_layer S={S} B={B} M={M} H={H}"))
    # the kernel's reciprocal against the IEEE division, every float it takes
    check = _cuda.load("lstm_step").gordo_lstm_rcp_check
    check.argtypes, check.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int32, device="cuda")
    if check(mismatches.data_ptr(), torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("lstm_step reciprocal self-test did not launch")
    if int(mismatches) != 0:
        raise AssertionError(f"rcp_in_range differs from 1.0f / y on {int(mismatches)} values")
    gate_mismatches, arith_mismatches = bf16_self_tests()
    # the kernel has no backward: both wrappers refuse an input that autograd
    # would differentiate through it
    xz, h, c, Wh, b = lstm_case(4, 3, 2, 8, seed=198)
    for name, fn, args in (
        ("lstm_layer", seq_scan.lstm_layer, (xz.requires_grad_(), Wh, b)),
        ("fused_lstm_step", seq_scan.fused_lstm_step, (xz[0].detach(), h, c, Wh.requires_grad_(), b)),
    ):
        try:
            fn(*args)
        except RuntimeError as exc:
            if "forward-only" not in str(exc):
                raise
        else:
            raise AssertionError(f"{name} launched on an input that requires grad")
    S, B, M, H = LSTM_SERVE
    xz, h, c, Wh, b = lstm_case(S, B, M, H, seed=199)
    step = (xz[0].contiguous(), h, c, Wh, b)
    step_bound, _ = lstm_bound(1, B, M, H)
    phase("parity", kernel="fused_lstm_step", steps=1, shapes=len(shapes),
          band="rtol=atol=1e-6", max_err=step_err, rcp_bitwise_over="[1,2^126)",
          rcp_mismatches=int(mismatches), bf16_gate_table_mismatches=json.dumps(gate_mismatches),
          bf16x2_arith_mismatches=json.dumps(arith_mismatches),
          refuses_requires_grad="lstm_layer,fused_lstm_step",
          kernel_device_us=kernel_device_us(seq_scan.fused_lstm_step, step,
                                            kernel="lstm_steps"),
          ms=round(time_ms(seq_scan.fused_lstm_step, step), 5),
          plain_ms=round(time_ms(seq_scan.lstm_step_plain, step), 5),
          library_ms=round(time_ms(library_step, step), 5), bound_ms=round(step_bound, 6))
    layer = (xz, Wh, b)
    bound, bound_by = lstm_bound(S, B, M, H)
    result = {
        "name": "lstm_layer", "route": "cuda", "source": LSTM_SOURCE,
        "replaces": KERNELS["lstm_layer"], "launches": None, "max_abs_err": layer_err,
        "ms": time_ms(seq_scan.lstm_layer, layer),
        "plain_ms": time_ms(seq_scan.lstm_layer_plain, layer, warmup=3, runs=20),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(library_layer, layer, warmup=3, runs=20),
    }
    phase("parity", kernel="lstm_layer", steps=S, shapes=len(shapes),
          band="rtol=1e-5,atol=1e-6", max_err=layer_err,
          kernel_device_us=kernel_device_us(seq_scan.lstm_layer, layer,
                                            kernel="lstm_steps"),
          ms=round(result["ms"], 5), plain_ms=round(result["plain_ms"], 5),
          library_ms=round(result["library_ms"], 5), bound_ms=round(bound, 6),
          bound_by=bound_by)
    # every layer of the LSTM bank's batch: device us against the bound
    device_us, bound_us = {}, {}
    for H in sorted(set(HOURGLASS_WIDTHS)):
        xz, _, _, Wh, b = lstm_case(S, B, M, H, seed=300 + H)
        device_us[H] = kernel_device_us(seq_scan.lstm_layer, (xz, Wh, b), kernel="lstm_steps")
        bound_us[H] = lstm_bound(S, B, M, H)[0] * 1e3
    # the same layer for one member: at most one warp an SM, so its time is
    # the latency of the step chain alone
    H = LSTM_SERVE[3]
    xz, _, _, Wh, b = lstm_case(S, B, 1, H, seed=400)
    one_member_us = kernel_device_us(seq_scan.lstm_layer, (xz, Wh, b), kernel="lstm_steps")
    phase("lstm_layers", S=S, B=B, M=M, H=json.dumps(HOURGLASS_WIDTHS),
          device_us=json.dumps([device_us[H] for H in HOURGLASS_WIDTHS]),
          bound_us=json.dumps([round(bound_us[H], 3) for H in HOURGLASS_WIDTHS]),
          bound_share=json.dumps([round(bound_us[H] / device_us[H], 4) if device_us[H] else None
                                  for H in HOURGLASS_WIDTHS]),
          sum_device_us=round(sum(device_us[H] or 0.0 for H in HOURGLASS_WIDTHS), 3),
          one_member_device_us=one_member_us, one_member_H=H)
    return {"lstm_layer": result}


def bf16_case(S, B, M, H, seed):
    """:func:`lstm_case` with xz, Wh and b in bfloat16 (h, c float32)."""
    xz, h, c, Wh, b = lstm_case(S, B, M, H, seed)
    return xz.bfloat16(), h, c, Wh.bfloat16(), b.bfloat16()


def bf16_reading(got, want, what):
    """(max abs error, that error in bfloat16 ulps of max |want|, share of
    values bitwise equal) of a bfloat16 K3 result against its plain
    version."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    ulp = float(2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else 2.0 ** -133
    return err, err / ulp, float((got == want).float().mean())


def within(reading, limits) -> bool:
    _, ulps, share = reading
    return share >= limits[0] and ulps <= limits[1]


def k3_bf16_layer_limits(shape):
    return K3_BF16_LAYER_WIDE.get(tuple(shape), K3_BF16_LAYER[0]), K3_BF16_LAYER[1]


def hold_bf16(got, want, limits, what):
    """The bfloat16 reading of ``got``; raises outside ``limits``."""
    reading = bf16_reading(got, want, what)
    if not within(reading, limits):
        raise AssertionError(f"{what}: max err {reading[0]} ({reading[1]:.3f} ulps), bitwise share "
                             f"{reading[2]}, outside (share >= {limits[0]}, ulps <= {limits[1]})")
    return reading


def k3_bf16_arith(xz, h0, c0, Wh, b):
    """S steps of K3-bf16's arithmetic design
    (``gordo_lstm_steps_bf16_arith``, the float arithmetic of every rounding
    point), the yardstick the main path's design is held to bitwise and
    timed against; nothing in the package calls it. Its plan on the warp
    path is the one it had as the instance (the float32 plan's at half its
    shared memory), on the block path the bfloat16 plan without the gate
    tables. Returns (ys, c) as ``seq_scan._launch``."""
    S, B, M, H4 = xz.shape
    H = H4 // 4
    if H <= seq_scan.WARP_MAX_HIDDEN:
        plan = seq_scan._launch_plan(B, M, H, 4)
        smem = plan.smem_bytes // 2
    else:
        plan = seq_scan._launch_plan(B, M, H, 2)
        smem = plan.smem_bytes - plan.tables
    fn = _cuda.load("lstm_step").gordo_lstm_steps_bf16_arith
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, p, p, p, p, *[i] * 12, p, p, p], ctypes.c_int
    ys = torch.empty((S, B, M, H), device=xz.device)
    c = torch.empty((B, M, H), device=xz.device)
    err = fn(xz.data_ptr(), None if h0 is None else h0.data_ptr(), None if c0 is None else c0.data_ptr(),
             Wh.data_ptr(), b.data_ptr(), S, B, M, H, plan.group, plan.tile, plan.threads, plan.stages,
             int(plan.stage_w), smem, *plan.grid, ys.data_ptr(), c.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gordo_lstm_steps_bf16_arith launch failed: cudaError {err}")
    return ys, c


def lstm_layer_bf16_arith(xz, Wh, b):
    return k3_bf16_arith(xz, None, None, Wh, b)[0]


def same_bits(got, want, what):
    """Raise unless the two float32 tensors are equal bit for bit."""
    if got.shape != want.shape or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        diff = int((got != want).sum()) if got.shape == want.shape else None
        raise AssertionError(f"{what}: the bf16 design differs from the arithmetic design ({diff} values)")


def k3_bf16_designs_us(args, runs=50):
    """Mean device us of K3-bf16's two designs on the same layer inputs
    ``(xz, Wh, b)`` (warp path), both launched in turns (the main path's
    design, then the arithmetic one) in each capture: (design us,
    arithmetic us)."""
    def both(*a):
        seq_scan.lstm_layer(*a)
        lstm_layer_bf16_arith(*a)

    return (kernel_device_us(both, args, runs=runs, kernel="lstm_steps_warp_tables"),
            kernel_device_us(both, args, runs=runs, kernel="lstm_steps_warp<__nv_bfloat16"))


def bf16_kernel_phase():
    """K3's bfloat16 instance against its bfloat16 plain versions, one step
    and a layer, at the serving shape, the ragged and edge shapes of the
    float32 phase and the misaligned steps, each within its limits; the
    control (the fp32 instance on the inputs cast up to float32) must fall
    outside them at every shape. At every shape the design equals the
    arithmetic design (its yardstick) bit for bit. Times at the serving
    shape, then both designs' device us in turns at every hourglass width,
    one member and the error passes' training shapes."""
    resolve_device("cuda")  # bfloat16 products reduced in float32 for the plain versions
    shapes = [LSTM_SERVE, *LSTM_RAGGED, *LSTM_EDGES, *BF16_MISALIGNED]
    worst = {k: {"err": 0.0, "ulps": 0.0, "share": 1.0, "control_share": 0.0,
                 "control_ulps": float("inf")} for k in ("fused_lstm_step", "lstm_layer")}

    def hold(name, got, control, want, limits, what):
        e, u, q = hold_bf16(got, want, limits, what)
        ctl = bf16_reading(control, want, f"{what} control")
        if within(ctl, limits):
            raise AssertionError(f"{what}: the float32 control passes the limits {limits} "
                                 f"(share {ctl[2]}, {ctl[1]:.3f} ulps)")
        w = worst[name]
        w.update(err=max(w["err"], e), ulps=max(w["ulps"], u), share=min(w["share"], q),
                 control_share=max(w["control_share"], ctl[2]),
                 control_ulps=min(w["control_ulps"], ctl[1]))
        return q

    for i, (S, B, M, H) in enumerate(shapes):
        xz, h, c, Wh, b = bf16_case(S, B, M, H, seed=600 + i)
        up = (xz.float(), Wh.float(), b.float())
        got = seq_scan.fused_lstm_step(xz[0], h, c, Wh, b)
        control = seq_scan.fused_lstm_step(up[0][0], h, c, up[1], up[2])
        torch.cuda.synchronize()
        yard_ys, yard_c = k3_bf16_arith(xz[:1], h, c, Wh, b)
        for g, k, w, y, name in zip(got, control, seq_scan.lstm_step_plain(xz[0], h, c, Wh, b),
                                    (yard_c, yard_ys[0]), ("c", "h")):
            hold("fused_lstm_step", g, k, w, K3_BF16_STEP, f"fused_lstm_step bf16 {name} B={B} M={M} H={H}")
            same_bits(g, y, f"fused_lstm_step bf16 {name} B={B} M={M} H={H}")
        got, control = seq_scan.lstm_layer(xz, Wh, b), seq_scan.lstm_layer(*up)
        torch.cuda.synchronize()
        same_bits(got, lstm_layer_bf16_arith(xz, Wh, b), f"lstm_layer bf16 S={S} B={B} M={M} H={H}")
        q = hold("lstm_layer", got, control, seq_scan.lstm_layer_plain(xz, Wh, b),
                 k3_bf16_layer_limits((S, B, M, H)), f"lstm_layer bf16 S={S} B={B} M={M} H={H}")
        serve_share = q if i == 0 else serve_share

    def held(name):
        w = worst[name]
        return dict(max_err=w["err"], max_ulps=round(w["ulps"], 4), bitwise_share=w["share"],
                    control_max_bitwise_share=w["control_share"],
                    control_min_ulps=round(w["control_ulps"], 4))

    S, B, M, H = LSTM_SERVE
    xz, h, c, Wh, b = bf16_case(S, B, M, H, seed=699)
    step = (xz[0], h, c, Wh, b)
    phase("bf16_kernel", kernel="fused_lstm_step_bf16", steps=1, shapes=len(shapes),
          limits=json.dumps(f"bitwise share >= {K3_BF16_STEP[0]}, <= {K3_BF16_STEP[1]} ulps; "
                            "the fp32 control outside"),
          **held("fused_lstm_step"), arith_bitwise_shapes=f"{len(shapes)}/{len(shapes)}",
          misaligned=json.dumps(BF16_MISALIGNED),
          kernel_device_us=kernel_device_us(seq_scan.fused_lstm_step, step, kernel="lstm_steps"),
          ms=round(time_ms(seq_scan.fused_lstm_step, step), 5),
          plain_ms=round(time_ms(seq_scan.lstm_step_plain, step), 5),
          library_ms=round(time_ms(library_step, step), 5),
          bound_ms=round(lstm_bound(1, B, M, H, elem_bytes=2)[0], 6))
    layer = (xz, Wh, b)
    bound, bound_by = lstm_bound(S, B, M, H, elem_bytes=2)
    result = {
        "name": "lstm_layer_bf16", "route": "cuda", "source": LSTM_SOURCE,
        "replaces": KERNELS["lstm_layer_bf16"], "launches": None, "max_abs_err": worst["lstm_layer"]["err"],
        "ms": time_ms(seq_scan.lstm_layer, layer),
        "plain_ms": time_ms(seq_scan.lstm_layer_plain, layer, warmup=3, runs=20),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(library_layer, layer, warmup=3, runs=20),
    }
    f32 = lstm_case(S, B, M, H, seed=699)
    phase("bf16_kernel", kernel="lstm_layer_bf16", steps=S, shapes=len(shapes),
          limits=json.dumps(f"bitwise share >= {K3_BF16_LAYER[0]} (wide shapes "
                            f"{sorted(K3_BF16_LAYER_WIDE.values())}), <= {K3_BF16_LAYER[1]} ulps; "
                            "the fp32 control outside"),
          **held("lstm_layer"), serving_bitwise_share=serve_share,
          arith_bitwise_shapes=f"{len(shapes)}/{len(shapes)}",
          kernel_device_us=kernel_device_us(seq_scan.lstm_layer, layer, kernel="lstm_steps"),
          f32_kernel_device_us=kernel_device_us(seq_scan.lstm_layer, (f32[0], f32[3], f32[4]),
                                                kernel="lstm_steps"),
          ms=round(result["ms"], 5), plain_ms=round(result["plain_ms"], 5),
          library_ms=round(result["library_ms"], 5), bound_ms=round(bound, 6), bound_by=bound_by,
          f32_bound_ms=round(lstm_bound(S, B, M, H)[0], 6))
    bf16_lstm_layers()
    return {"lstm_layer_bf16": result}


def bf16_lstm_layers():
    """The ``lstm_layers`` line for K3-bf16: both designs' device us, in
    turns, at every layer of the LSTM bank's batch against the bound, for
    one member (the step chain's latency alone) and at the error passes'
    training shapes."""
    S, B, M, _ = LSTM_SERVE
    us, bound = {}, {}
    for H in sorted(set(HOURGLASS_WIDTHS)):
        xz, _, _, Wh, b = bf16_case(S, B, M, H, seed=700 + H)
        us[H] = k3_bf16_designs_us((xz, Wh, b))
        bound[H] = lstm_bound(S, B, M, H, elem_bytes=2)[0] * 1e3
    H = LSTM_SERVE[3]
    xz, _, _, Wh, b = bf16_case(S, B, 1, H, seed=710)
    one = k3_bf16_designs_us((xz, Wh, b))
    one_s8 = k3_bf16_designs_us((xz[:8].contiguous(), Wh, b))  # with `one`: a step's latency and the rest
    train = {}
    for S_, B_, M_, H_ in LSTM_TRAIN[:3]:
        xz, _, _, Wh, b = bf16_case(S_, B_, M_, H_, seed=720 + H_)
        t_us, p_us = k3_bf16_designs_us((xz, Wh, b), runs=20)
        train[f"{S_}x{B_}x{M_}x{H_}"] = dict(device_us=t_us, arith_device_us=p_us,
                                           bound_us=round(lstm_bound(S_, B_, M_, H_, elem_bytes=2)[0] * 1e3, 3))
        del xz, Wh, b
    phase("bf16_lstm_layers", S=S, B=B, M=M, H=json.dumps(HOURGLASS_WIDTHS), turns="design,arith a launch each",
          device_us=json.dumps([us[H][0] for H in HOURGLASS_WIDTHS]),
          arith_device_us=json.dumps([us[H][1] for H in HOURGLASS_WIDTHS]),
          bound_us=json.dumps([round(bound[H], 3) for H in HOURGLASS_WIDTHS]),
          bound_share=json.dumps([round(bound[H] / us[H][0], 4) if us[H][0] else None
                                  for H in HOURGLASS_WIDTHS]),
          arith_bound_share=json.dumps([round(bound[H] / us[H][1], 4) if us[H][1] else None
                                      for H in HOURGLASS_WIDTHS]),
          sum_device_us=round(sum(us[H][0] or 0.0 for H in HOURGLASS_WIDTHS), 3),
          arith_sum_device_us=round(sum(us[H][1] or 0.0 for H in HOURGLASS_WIDTHS), 3),
          one_member_device_us=one[0], arith_one_member_device_us=one[1], one_member_H=H,
          one_member_S8_device_us=one_s8[0], arith_one_member_S8_device_us=one_s8[1],
          train=json.dumps(train))


def record_path_shapes():
    """From here on, add the shape of every kernel call on the card to
    PATH_SHAPES (through the wrappers' launch functions and
    ``seq_scan.lstm_layer``); the kernels and their counts are untouched."""
    one, banked, layer = score._launch_one, score._launch_banked, seq_scan.lstm_layer

    def k1(target, output, shift, scale):
        PATH_SHAPES["fused_anomaly_score"].add(tuple(target.shape))
        return one(target, output, shift, scale)

    def k2(target, output, shift_bank, scale_bank, idx):
        PATH_SHAPES["banked_anomaly_score"].add((*target.shape, shift_bank.shape[0]))
        return banked(target, output, shift_bank, scale_bank, idx)

    def k3(xz, Wh, b):
        if xz.is_cuda:
            name = "lstm_layer_bf16" if xz.dtype == torch.bfloat16 else "lstm_layer"
            PATH_SHAPES[name].add((*xz.shape[:3], xz.shape[3] // 4))
        return layer(xz, Wh, b)

    score._launch_one, score._launch_banked, seq_scan.lstm_layer = k1, k2, k3


def k1_case(rows, F, seed):
    """One detector's (rows, F) reconstruction and scaler row pair."""
    tgt, out, sh, sc, _ = make_case(1, rows, F, 1, seed)
    return tgt[0], out[0], sh[0], sc[0]


def hold_k1(shape, seed):
    single = k1_case(*shape, seed)
    got = score.fused_anomaly_score(*single)
    torch.cuda.synchronize()
    return compare(got, score.score_plain(*single), "fused at the main path's rows={} F={}".format(*shape))


def hold_k2(shape, seed):
    args = make_case(*shape, seed=seed)
    buf = score.banked_anomaly_score_packed(*args)
    torch.cuda.synchronize()
    return compare_packed(buf, args, "banked at the main path's B={} T={} F={} M={}".format(*shape))


def hold_k3(shape, seed):
    xz, _, _, Wh, b = lstm_case(*shape, seed=seed)
    got = seq_scan.lstm_layer(xz, Wh, b)
    torch.cuda.synchronize()
    return close(got, seq_scan.lstm_layer_plain(xz, Wh, b), LAYER_RTOL, LAYER_ATOL,
                 "lstm_layer at the main path's S={} B={} M={} H={}".format(*shape))


def hold_k3_bf16(shape, seed):
    xz, _, _, Wh, b = bf16_case(*shape, seed=seed)
    got = seq_scan.lstm_layer(xz, Wh, b)
    torch.cuda.synchronize()
    same_bits(got, lstm_layer_bf16_arith(xz, Wh, b), "lstm_layer_bf16 at the main path's S={} B={} M={} H={}".format(*shape))
    return hold_bf16(got, seq_scan.lstm_layer_plain(xz, Wh, b), k3_bf16_layer_limits(shape),
                     "lstm_layer_bf16 at the main path's S={} B={} M={} H={}".format(*shape))[0]


def path_parity_phase(kernels):
    """Each kernel against its plain version, in the parity phase's band, at
    every shape the main paths gave it that the parity phase did not hold;
    each kernel's max_abs_err covers both."""
    checks = {
        "fused_anomaly_score": (hold_k1, {(t, f) for _, t, f, _ in (SERVE_SHAPE, *RAGGED)},
                                f"bitwise diff,scaled; norms rtol=atol={NORM_RTOL}"),
        "banked_anomaly_score": (hold_k2, set(K2_SHAPES),
                                 f"bitwise output_copy,diff,scaled; norms rtol=atol={NORM_RTOL}"),
        "lstm_layer": (hold_k3, {LSTM_SERVE, *LSTM_RAGGED, *LSTM_EDGES, *LSTM_TRAIN},
                       f"rtol={LAYER_RTOL},atol={LAYER_ATOL}"),
        "lstm_layer_bf16": (hold_k3_bf16, {LSTM_SERVE, *LSTM_RAGGED, *LSTM_EDGES, *BF16_MISALIGNED},
                            f"bitwise share >= {K3_BF16_LAYER[0]}, <= {K3_BF16_LAYER[1]} bf16 ulps; "
                            "bitwise the arithmetic design"),
    }
    for name, (hold, held, band) in checks.items():
        shapes = PATH_SHAPES[name]
        new = sorted(shapes - held)
        err = max([hold(shape, 500 + i) for i, shape in enumerate(new)], default=0.0)
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
        phase("path_parity", kernel=name, path_shapes=len(shapes), held_before=len(shapes) - len(new),
              held_now=len(new), band=json.dumps(band), max_err=err, shapes=json.dumps(new[:40]))


# ------------------------------------------------------------------ #
# phases 4-6: the served path
# ------------------------------------------------------------------ #


def random_entry(name: str, n_features: int, rng: np.random.Generator):
    enc = hourglass_calc_dims(0.5, 3, n_features)
    dims = [n_features, *enc, *enc[::-1], n_features]
    params = {"params": {
        f"Dense_{i}": {
            "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }}
    return entry_from_numpy(
        name, "AutoEncoder", "feedforward_hourglass", {}, n_features, params,
        in_shift=0.1 * rng.standard_normal(n_features),
        in_scale=1.0 + rng.random(n_features),
        err_shift=0.05 * rng.random(n_features),
        err_scale=1.0 + rng.random(n_features),
        tags=[f"tag-{i}" for i in range(n_features)],
    )


@functools.lru_cache(maxsize=None)
def state_shapes(registry_type: str, kind: str, F: int):
    module = lookup_factory(registry_type, kind)(F)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def random_zoo_entry(name: str, family: str, rng: np.random.Generator):
    """A config-4 detector at 10 tags with random weights (kernels scaled by
    their fan-in, small biases) and scalers: the conv autoencoder (default
    channels, lookback 32) or the variational one (default widths)."""
    F = 10
    registry_type, kind = {"conv": ("ConvAutoEncoder", "conv1d_autoencoder"),
                           "vae": ("AutoEncoder", "feedforward_variational")}[family]
    state = {
        k: ((0.1 if k.endswith(".bias") else 1.0 / np.sqrt(np.prod(shape[:-1])))
            * rng.standard_normal(shape)).astype(np.float32)
        for k, shape in state_shapes(registry_type, kind, F).items()
    }
    return entry_from_numpy(
        name, registry_type, kind, {}, F, params_to_flax(state),
        in_shift=0.1 * rng.standard_normal(F),
        in_scale=1.0 + rng.random(F),
        err_shift=0.05 * rng.random(F),
        err_scale=1.0 + rng.random(F),
        tags=[f"tag-{i}" for i in range(F)],
        lookback=LOOKBACK if family == "conv" else 1,
    )


def random_lstm_entry(name: str, registry_type: str, rng: np.random.Generator):
    """An ``lstm_hourglass`` detector at 10 tags, lookback 32, with random
    weights (columns of unit variance) and scalers; forecasters predict t+1."""
    F = 10
    state = {
        k: ((0.1 if k.endswith(".b") or k == "head.bias" else 1.0 / np.sqrt(shape[0]))
            * rng.standard_normal(shape)).astype(np.float32)
        for k, shape in state_shapes("LSTMAutoEncoder", "lstm_hourglass", F).items()
    }
    return entry_from_numpy(
        name, registry_type, "lstm_hourglass", {}, F, lstm_to_flax(state),
        in_shift=0.1 * rng.standard_normal(F),
        in_scale=1.0 + rng.random(F),
        err_shift=0.05 * rng.random(F),
        err_scale=1.0 + rng.random(F),
        tags=[f"tag-{i}" for i in range(F)],
        lookback=LOOKBACK, target_offset=int(registry_type == "LSTMForecast"),
    )


def http_raw(url: str, raw: bytes = None, headers=None):
    """(status, headers, body bytes) of one request."""
    req = urllib.request.Request(url, data=raw, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def http_json(url: str, body=None, raw: bytes = None, content_type: str = "application/json"):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    status, _, out = http_raw(url, data, {"Content-Type": content_type})
    return status, json.loads(out)


def check_arrays(got: dict, want: dict, what: str, rtol=0.0, atol=E2E_ATOL) -> None:
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{what}: {key} has shape {g.shape} or non-finite values")
        if not np.allclose(g, w, rtol=rtol, atol=atol):
            err = float(np.abs(g - w).max())
            raise AssertionError(f"{what}: {key} off by {err} (rtol={rtol}, atol={atol})")


def check_bf16_arrays(got: dict, want: dict, what: str, limits) -> tuple:
    """A bfloat16 model's arrays on the card against the CPU's: each within
    BF16_ATOL * max(1, its largest value), the JAX suite's bfloat16 band (a
    rounding that falls the other way on one side moves a value by a
    bfloat16 ulp), and the model output (bfloat16 cast up, so an ulp is its
    grain) within ``limits`` (least share bitwise, most bf16 ulps); the
    largest error, the output's ulps and its share bitwise."""
    worst = 0.0
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{what}: {key} has shape {g.shape} or non-finite values")
        err = float(np.abs(g - w).max()) if g.size else 0.0
        if err > BF16_ATOL * max(1.0, float(np.abs(w).max()) if w.size else 0.0):
            raise AssertionError(f"{what}: {key} off by {err} (bfloat16 band {BF16_ATOL} x max(1, |x|))")
        worst = max(worst, err)
    _, ulps, share = hold_bf16(*(torch.from_numpy(np.array(a["model-output"], np.float32))
                                 for a in (got, want)), limits, f"{what} model-output")
    return worst, ulps, share


def response_arrays(body: dict, tags, output_tags=None) -> dict:
    """An anomaly body's six groups as arrays: ``model-input`` by ``tags``,
    the model-space groups by ``output_tags`` (a pipeline that is not
    affine names its transformed columns so), else by ``tags``."""
    data = body["data"]
    out = {k: np.asarray([data[k][t] for t in (tags if k == "model-input" or output_tags is None
                                                else output_tags)], np.float32).T
           for k in ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled")}
    out.update({k: np.asarray(data[k], np.float32)
                for k in ("total-anomaly-unscaled", "total-anomaly-scaled")})
    return out


def http_phase():
    shutil.rmtree(MODEL_DIR, ignore_errors=True)
    rng = np.random.default_rng(1)
    widths = {f"m{i:03d}": 10 for i in range(64)} | {f"w{i:03d}": 40 for i in range(8)}
    for name, f in widths.items():
        serializer.dump(random_entry(name, f, rng), os.path.join(MODEL_DIR, name))
    lstm = {f"lae{i}": "LSTMAutoEncoder" for i in range(8)} | {f"lfc{i}": "LSTMForecast" for i in range(4)}
    for name, registry_type in lstm.items():
        serializer.dump(random_lstm_entry(name, registry_type, rng), os.path.join(MODEL_DIR, name))
    # config 4: a conv bucket (lookback 32) and a variational one
    zoo = {f"cae{i}": "conv" for i in range(4)} | {f"vae{i}": "vae" for i in range(4)}
    for name, family in zoo.items():
        serializer.dump(random_zoo_entry(name, family, rng), os.path.join(MODEL_DIR, name))
    widths |= {name: 10 for name in (*lstm, *zoo)}
    offsets = {name: LOOKBACK - 1 + int(t == "LSTMForecast") for name, t in lstm.items()}
    offsets |= {name: LOOKBACK - 1 for name, family in zoo.items() if family == "conv"}
    banded = {*lstm, *zoo}  # held in the LSTM band: deeper sums than the hourglass's
    server = run_server(MODEL_DIR, host="127.0.0.1", port=0, background=True)
    try:
        base = server.url + "/gordo/v0/smoke"
        status, models = http_json(base + "/models")
        if status != 200 or models["models"] != sorted(widths) or models["bank"]["n_buckets"] != 6:
            raise AssertionError(f"/models answered {status}: {models}")
        status, body = http_json(base + "/m000/healthcheck")
        if status != 200 or "gordo-server-version" not in body:
            raise AssertionError(f"healthcheck answered {status}: {body}")
        # concurrent POSTs: 56 to the 10-tag dense bucket and 8 to the 40-tag
        # one (64 rows each), and one to every LSTM and config-4 detector
        # (128 rows a windowed one, 64 a variational one)
        targets = [f"m{i:03d}" for i in range(56)] + [f"w{i:03d}" for i in range(8)] + [*lstm, *zoo]
        n_rows = {t: 128 if t in offsets else 64 for t in targets}
        index = [f"2020-01-01T{m // 60:02d}:{m % 60:02d}:00Z" for m in range(128)]
        X = {t: rng.random((n_rows[t], widths[t])).astype(np.float32) for t in targets}
        replies = {}

        def post(t):
            replies[t] = http_json(f"{base}/{t}/anomaly/prediction",
                                   {"X": X[t].tolist(), "index": index[:n_rows[t]]})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(t,)) for t in targets]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180)
            if th.is_alive():
                raise AssertionError("an HTTP client did not finish")
        wall = time.perf_counter() - t0
        # the config-4 buckets alone, one request each: K2 once a bucket
        k2_before = score.launch_counts["banked_anomaly_score"]
        server.app.bank.score_many([(t, X[t], None) for t in zoo])
        zoo_k2 = score.launch_counts["banked_anomaly_score"] - k2_before
        if zoo_k2 != 2:
            raise AssertionError(f"http: the conv and variational buckets launched K2 {zoo_k2} times, not 2")
        zoo_k1 = 0
        for t in targets:
            status, body = replies[t]
            if status != 200:
                raise AssertionError(f"{t}: anomaly/prediction answered {status}: {body}")
            off = offsets.get(t, 0)
            want_index = [s.replace("Z", "+00:00") for s in index[off:n_rows[t]]]
            if body["index"] != want_index:
                raise AssertionError(f"{t}: index {body['index'][:2]}... not trimmed by {off}")
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if t in banded else {}
            path = os.path.join(MODEL_DIR, t)
            plain = serializer.load(path, device="cpu").anomaly(X[t])
            check_arrays(response_arrays(body, [f"tag-{i}" for i in range(widths[t])]), plain,
                         f"http {t}", **band)
            # the detector's own anomaly() on the card: the per-model kernel
            # (and, for an LSTM, the fused step)
            k1_before = score.launch_counts["fused_anomaly_score"]
            check_arrays(serializer.load(path).anomaly(X[t]), plain, f"detector {t}", **band)
            if t in zoo:
                zoo_k1 += score.launch_counts["fused_anomaly_score"] - k1_before
        for t in ("lae0", "lfc0"):
            status, body = http_json(f"{base}/{t}/prediction", {"X": X[t].tolist(), "index": index})
            plain = serializer.load(os.path.join(MODEL_DIR, t), device="cpu").anomaly(X[t])
            want_index = [s.replace("T", " ").replace("Z", "+00:00") for s in index[offsets[t]:]]
            if status != 200 or body["index"] != want_index:
                raise AssertionError(f"{t}: /prediction answered {status} or an untrimmed index")
            check_arrays({"model-output": body["data"]}, {"model-output": plain["model-output"]},
                         f"prediction {t}", rtol=LSTM_RTOL, atol=LSTM_ATOL)
            short = X[t][: offsets[t]].tolist()
            status, body = http_json(f"{base}/{t}/anomaly/prediction", {"X": short})
            if status != 400:
                raise AssertionError(f"{t}: a {offsets[t]}-row request answered {status}: {body}")
        status, body = http_json(base + "/m000/anomaly/prediction", raw=b"not json")
        if status != 400:
            raise AssertionError(f"bad body answered {status}: {body}")
        status, body = http_json(base + "/ghost/anomaly/prediction", {"X": X["m000"].tolist()})
        if status != 404:
            raise AssertionError(f"unknown target answered {status}: {body}")
        batches = server.app.engine.stats["batches"]
    finally:
        server.close()
        shutil.rmtree(MODEL_DIR, ignore_errors=True)
    if zoo_k1 != len(zoo):
        raise AssertionError(f"http: the config-4 detectors' anomaly() launched K1 {zoo_k1} times")
    phase("http", models=len(widths), buckets=6, posts=len(targets), rows="64,128(lstm,conv)",
          wall_s=round(wall, 4), engine_batches=batches,
          checked="all six arrays vs CPU plain", index_trimmed_by="31,32",
          status_400="bad body,warm-up", status_404=True,
          zoo_detectors=json.dumps({"conv": 4, "vae": 4}), zoo_k2_launches=zoo_k2, zoo_k1_launches=zoo_k1)


def profile_batch(bank, requests, runs=5):
    """Where one full bank call of ``requests`` spends its time: the median
    host wall time of ``runs`` calls, and from one call under the profiler
    the device time of every kernel and copy, summed, and their count."""
    from torch.profiler import ProfilerActivity

    walls = []
    for _ in range(runs + 1):  # the first call warms the allocator
        t0 = time.perf_counter()
        bank.score_many(requests)  # ends in a device-to-host copy
        walls.append(time.perf_counter() - t0)
    events, _, empty = device_trace(lambda: (bank.score_many(requests), torch.cuda.synchronize()),
                                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    wall_ms = statistics.median(walls[1:]) * 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {
        "batch_wall_ms": round(wall_ms, 4), "batch_device_ms": round(device_ms, 4),
        "device_busy_share": round(device_ms / wall_ms, 4), "device_ops": len(events),
        "top_device_ms": json.dumps({k[:40]: round(v, 4) for k, v in top}), **empty,
    }


def closed_loop(engine, names, X, what: str):
    """Closed-loop clients, one thread each: client c scores ``names[c][r]``
    on ``X[c, r]`` for r in order through ``engine``, all starting at once.
    Returns (latencies s, {(c, r): result}, wall s); any failure raises."""
    n_clients, n_requests = len(names), len(names[0])
    lat, results, failures = [], {}, []
    barrier = threading.Barrier(n_clients)

    def client(c):
        try:
            barrier.wait(60)
            for r in range(n_requests):
                t = time.perf_counter()
                results[(c, r)] = engine.score_blocking(names[c][r], X[c, r], timeout=120)
                lat.append(time.perf_counter() - t)
        except Exception as exc:  # reported below: the phase fails
            failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    if failures or len(results) != n_clients * n_requests:
        raise AssertionError(f"{what}: {len(results)} results, failures {failures[:3]}")
    return lat, results, wall


def bank_phase(card: str, family: str = "dense", dtype: str = "float32"):
    """A 10,000-member bank driven by 64 closed-loop clients through the
    engine: dense hourglass members with 64-row requests, or LSTM hourglass
    (``family="lstm"``) or config-4 conv members (``"conv"``), lookback 32,
    with 128-row requests; the members compute in ``dtype``."""
    rng = np.random.default_rng({"dense": 2, "lstm": 3, "conv": 4}[family])
    n_members, n_clients, n_requests = 10_000, 64, 4
    windowed = family != "dense"
    n_rows = 128 if windowed else 64
    t0 = time.perf_counter()
    if family == "lstm":
        entries = [random_lstm_entry(f"l{i:05d}", "LSTMAutoEncoder", rng) for i in range(n_members)]
    elif family == "conv":
        entries = [random_zoo_entry(f"c{i:05d}", "conv", rng) for i in range(n_members)]
    else:
        entries = [random_entry(f"m{i:05d}", 10, rng) for i in range(n_members)]
    if dtype != "float32":
        entries = [dataclasses.replace(e, compute_dtype=dtype) for e in entries]
    # uninstrumented, as every in-process bank of the phases before observe:
    # their loops measure what they measured before the metrics registry
    bank = ModelBank.from_entries(entries, registry=False)
    build_s = time.perf_counter() - t0
    off = entries[0].offset
    # the cyclic collector's pass over the 10,000 freshly built entries
    # (about 0.2 s) runs here, not at whatever request of the timed loop
    # crosses its threshold, where it would stall every client at once
    gc.collect()
    engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
    engine.start()
    try:
        X = rng.random((n_clients, n_requests, n_rows, 10)).astype(np.float32)
        names = [[entries[int(j)].name for j in rng.integers(0, n_members, n_requests)]
                 for _ in range(n_clients)]
        engine.score_blocking(names[0][0], X[0, 0])  # first batch pays allocator warm-up
        before = dict(engine.stats)
        launches_before = dict(score.launch_counts, **seq_scan.launch_counts)
        lat, results, wall = closed_loop(engine, names, X, "bank phase")
        stats = {k: engine.stats[k] - before[k] for k in ("requests", "batches")}
        stats["max_batch_seen"] = engine.stats["max_batch_seen"]
        after = dict(score.launch_counts, **seq_scan.launch_counts)
        launches = {k: after[k] - launches_before[k] for k in after}
    finally:
        engine.stop()
    # one full batch alone, outside the engine: host wall vs device time
    profiled = profile_batch(bank, [(names[c][0], X[c, 0], None) for c in range(n_clients)])
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if windowed else {}
    by_name = {e.name: e for e in entries}
    readings = []  # bfloat16: (max err, model output's ulps, its bitwise share) of each held request
    for (c, r), res in results.items():
        arrays = res.to_arrays()
        if not all(np.all(np.isfinite(a)) for a in arrays.values()):
            raise AssertionError(f"bank phase: non-finite scores for {names[c][r]}")
        if len(res.model_output) != n_rows - off:
            raise AssertionError(f"bank phase: {len(res.model_output)} rows for {names[c][r]}")
        if c % 8 == 0:  # hold a sample against the CPU plain computation
            plain = DiffBasedAnomalyDetector.from_entry(by_name[names[c][r]], device="cpu")
            if dtype == BF16:
                readings.append(check_bf16_arrays(arrays, plain.anomaly(X[c, r]), f"bank {names[c][r]}",
                                                  BF16_BANK_VS_CPU[family]))
            else:
                check_arrays(arrays, plain.anomaly(X[c, r]), f"bank {names[c][r]}", **band)
    lat_ms = np.asarray(lat) * 1e3
    batches = max(stats["batches"], 1)
    summary = {
        "members": n_members, "clients": n_clients, "requests": len(results),
        "rows_per_request": n_rows, "scored_rows_per_request": n_rows - off,
        "build_s": round(build_s, 3),
        "bank_weight_mib": round(sum(v.nbytes for e in entries for v in e.params.values()) / 2**20, 1),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 4),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
        "rows_per_s": round(len(results) * (n_rows - off) / wall, 1),
        "avg_batch": round(stats["requests"] / batches, 3),
        "batches": stats["batches"], "max_batch_seen": stats["max_batch_seen"],
        "banked_launches_per_batch": round(launches["banked_anomaly_score"] / batches, 3),
    }
    if family == "lstm":
        k3 = "lstm_layer_bf16" if dtype == BF16 else "lstm_layer"
        summary[f"{k3}_launches_per_batch"] = round(launches[k3] / batches, 3)
    if readings:
        summary.update(vs_cpu_limits=json.dumps(BF16_BANK_VS_CPU[family]),
                       vs_cpu_max_err=max(x[0] for x in readings),
                       vs_cpu_output_max_ulps=round(max(x[1] for x in readings), 4),
                       vs_cpu_output_min_bitwise_share=min(x[2] for x in readings),
                       vs_cpu_output_bitwise_share=float(np.mean([x[2] for x in readings])))
    summary.update(profiled)
    name = {"dense": "bank", "lstm": "lstm", "conv": "zoo_bank"}[family]
    phase(name if dtype == "float32" else f"bf16_{name}", dtype=dtype, **summary, card=json.dumps(card))
    return summary


# ------------------------------------------------------------------ #
# phases 4-5: training
# ------------------------------------------------------------------ #


def synth_fleet(n_models: int, rows: int, n_features: int, seed: int = 0):
    """The reference bench's synthetic fleet (``bench.py`` ``_synth_fleet``):
    per member, sine waves of random frequency and phase plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(rows)
    out = {}
    for i in range(n_models):
        freqs = 0.01 + 0.002 * rng.rand(n_features)
        phases = 2 * np.pi * rng.rand(n_features)
        X = np.sin(np.outer(t, freqs) + phases) + rng.normal(scale=0.05, size=(rows, n_features))
        out[f"machine-{i}"] = X.astype("float32")
    return out


def device_trace(fn, activities, attempts=3):
    """``fn()`` under the profiler: the trace's device events, what ``fn``
    returned, and ``{"empty_traces": n}`` with the host operations each
    empty trace held. A trace that holds no device event is taken again:
    now and then one of a bank batch comes back so on an H100, while the
    same batch traced again holds all its events (PERF.md, section 6).
    Raises when ``attempts`` traces in a row hold none."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    empty = []
    for _ in range(attempts):
        with profile(activities=activities) as prof:
            result = fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        if device:
            return device, result, {"empty_traces": len(empty),
                                    "empty_trace_host_ops": json.dumps(empty)}
        empty.append(len(events))
    raise AssertionError(f"{attempts} traces in a row held no device events "
                         f"(host operations {empty})")


def stacked_block(members, batch_size: int, warmup: int = 0):
    """The members' rows stacked on the card as a fleet bucket holds them:
    rows (M, padded items + warmup, F), item masks (M, padded items), and the
    real items a member (all members have the same rows)."""
    arrays = np.stack(list(members.values()))
    M, rows, F = arrays.shape
    n_items = rows - warmup
    n_pad = quantize_batch_count(-(-n_items // batch_size)) * batch_size
    dev = torch.device("cuda")
    X = torch.zeros(M, n_pad + warmup, F, device=dev)
    X[:, :rows] = torch.from_numpy(arrays).to(dev)
    mask = (torch.arange(n_pad, device=dev) < n_items).float().expand(M, n_pad).contiguous()
    return X, mask, [n_items] * M


def profile_training(stack, X, mask, n_real, batch_size: int, loss: str = "mse"):
    """One training step and one epoch of the stacked train core over the
    rows ``X`` and item masks ``mask`` on the card, under the profiler:
    device operations of the step, and the epoch's device time against its
    wall time (``loss="vae"``: the ELBO, with noise drawn as the fit draws
    it). The profiler traces the device alone: tracing every host operation
    of an LSTM epoch (160,000 of them in bf16) cost tens of seconds and
    slowed the epoch it measured."""
    from torch.profiler import ProfilerActivity

    dev = X.device
    M, n_pad = mask.shape
    opt = train_core.make_optimizer("adam", 1e-3)
    init_fn, epoch_fn = train_core.make_train_fns(stack, opt, batch_size, loss=loss)
    step = train_core.make_step_fn(stack, opt, loss)
    state = init_fn([train_core.member_generator(0, i) for i in range(M)], dev)
    lr = torch.full((M,), 1e-3, device=dev)
    state, _ = epoch_fn(state, X, X, mask, lr, n_real=n_real)  # warm
    xb, yb = stack.batch(X, X, torch.arange(batch_size, device=dev).expand(M, batch_size))
    mb = mask[:, :batch_size]
    nb = torch.randn(M, batch_size, stack.latent_dim, device=dev) if loss == "vae" else None
    step(state.params, state.opt_state, xb, yb, mb, lr, nb)
    torch.cuda.synchronize()
    step_events, _, step_empty = device_trace(
        lambda: step(state.params, state.opt_state, xb, yb, mb, lr, nb), [ProfilerActivity.CUDA])
    step_ops = len(step_events)

    def epoch():
        t0 = time.perf_counter()
        out, losses = epoch_fn(state, X, X, mask, lr, n_real=n_real)
        losses.cpu()
        return out, (time.perf_counter() - t0) * 1e3

    events, (state, wall_ms), epoch_empty = device_trace(epoch, [ProfilerActivity.CUDA])
    clocks = card_clocks()
    by_kernel = {}  # device ms by kernel, template arguments dropped
    for e in events:
        kernel = e.name.removeprefix("void ").split("<")[0][:60]
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    # host pieces of an epoch, each timed alone (median of 5): the shuffle
    # (one randperm a member on the CPU, one copy, then a wait) and one
    # step's launches (the wait after it untimed)
    def median_ms(fn, wait_inside: bool) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            if wait_inside:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    shuffle_ms = median_ms(lambda: train_core.shuffle_perm(state.generators, n_real, n_pad, dev), True)
    launch_ms = median_ms(lambda: step(state.params, state.opt_state, xb, yb, mb, lr, nb), False)
    noise = {}
    if loss == "vae":  # the epoch's noise: drawn on the host, one copy
        noise["epoch_noise_ms"] = round(median_ms(lambda: train_core.draw_noise(
            state.generators, n_real, n_pad, batch_size, stack.latent_dim, dev), True), 3)
    return {
        "step_device_ops": step_ops, "step_launch_ms": round(launch_ms, 4),
        "epoch_steps": n_pad // batch_size, "epoch_shuffle_ms": round(shuffle_ms, 3), **noise,
        "epoch_device_ops": len(events), "profiled_epoch_wall_ms": round(wall_ms, 3),
        "epoch_device_ms": round(device_ms, 4),
        "profiled_epoch_busy_share": round(device_ms / wall_ms, 4),
        "epoch_top_device_ms": json.dumps({k: round(v, 3) for k, v in top}),
        "card_after_epoch": json.dumps(clocks),
        "empty_traces": step_empty["empty_traces"] + epoch_empty["empty_traces"],
    }


def train_phase(card: str):
    """FleetTrainer at full width: a warm fit, then a timed fit."""
    members = synth_fleet(**FLEET_SHAPE)
    FleetTrainer(**FLEET_CONFIG).fit(members)
    trainer = FleetTrainer(**FLEET_CONFIG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = trainer.fit(members)
    wall = time.perf_counter() - t0
    epochs = trainer.last_stats["buckets"][0]["epoch_seconds"]
    losses = np.array([m.history["loss"] for m in models.values()])
    if losses.shape != (len(members), FLEET_CONFIG["epochs"]) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: loss histories of shape {losses.shape} or non-finite")
    fell = float(np.mean(losses[:, -1] < losses[:, 0]))
    if fell < 0.99:
        raise AssertionError(f"train: the loss fell for a share of {fell} of the members, below 0.99")
    steady = statistics.median(epochs[1:])
    bs = FLEET_CONFIG["batch_size"]
    X, mask, n_real = stacked_block(members, bs)
    stack = train_core.StackedDense(lookup_factory("AutoEncoder", FLEET_CONFIG["kind"])(X.shape[-1]))
    prof = profile_training(stack, X, mask, n_real, bs)
    F32_RUNS["dense_fleet"] = run_summary(len(members), wall, epochs, prof)
    phase("train", members=len(members), rows=FLEET_SHAPE["rows"], tags=FLEET_SHAPE["n_features"],
          epochs=FLEET_CONFIG["epochs"], batch=FLEET_CONFIG["batch_size"], dtype="float32",
          padded=json.dumps({k: trainer.last_stats["buckets"][0][k]
                             for k in ("padded_rows", "padded_members")}),
          fit_wall_s=round(wall, 4), models_per_hour=round(len(members) / wall * 3600, 1),
          epoch_s=json.dumps(epochs), steady_epoch_s=round(steady, 4),
          loss_fell_share=fell, loss_epoch1_median=round(float(np.median(losses[:, 0])), 6),
          loss_epoch5_median=round(float(np.median(losses[:, -1])), 6),
          **prof, epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def run_summary(models: int, wall: float, epoch_s, prof) -> dict:
    """The numbers a training phase reports beside its other dtype's."""
    steady = statistics.median(epoch_s[1:])
    return {"models_per_hour": round(models / wall * 3600, 1), "fit_wall_s": round(wall, 4),
            "steady_epoch_s": round(steady, 4), "step_device_ops": prof["step_device_ops"],
            "step_launch_ms": prof["step_launch_ms"],
            "epoch_device_busy_share": round(prof["epoch_device_ms"] / 1e3 / steady, 4)}


def train_parity_phase():
    """The same small fleet from the same initial parameters on the card and
    on the CPU: one batch an epoch, so both see the same rows in each step."""
    members = synth_fleet(8, 256, 10, seed=5)
    module = lookup_factory("AutoEncoder", FLEET_CONFIG["kind"])(10)
    stack = train_core.StackedDense(module)
    init = stack.state_dicts(stack.init([train_core.member_generator(7, i) for i in range(8)]))
    initial = dict(zip(members, init))
    config = dict(kind=FLEET_CONFIG["kind"], epochs=3, batch_size=256)
    card = FleetTrainer(**config).fit(members, initial_params=initial)
    cpu = FleetTrainer(device="cpu", **config).fit(members, initial_params=initial)
    err = {"params": 0.0, "loss": 0.0, "error_scaler": 0.0, "thresholds": 0.0}

    def hold(got, want, what, key):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"train_parity: {what} outside rtol={TRAIN_RTOL}, atol={TRAIN_ATOL}")
        err[key] = max(err[key], float(np.abs(got - want).max()))

    for name in members:
        a, b = card[name], cpu[name]
        for k in b.params:
            hold(a.params[k], b.params[k], f"{name} {k}", "params")
        hold(a.history["loss"], b.history["loss"], f"{name} losses", "loss")
        for x, y in zip(a.error_scaler, b.error_scaler):
            hold(x, y, f"{name} error scaler", "error_scaler")
        hold(a.feature_thresholds, b.feature_thresholds, f"{name} feature thresholds", "thresholds")
        hold(a.total_threshold, b.total_threshold, f"{name} total threshold", "thresholds")
    phase("train_parity", members=len(members), rows=256, epochs=3, batch=256,
          band=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}",
          max_abs_err=json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}))


def lstm_launches() -> int:
    return seq_scan.launch_counts["lstm_layer"] + seq_scan.launch_counts["fused_lstm_step"]


def seq_train_phase(card: str):
    """The reference bench's config 2 as one fit, then its single build's
    detector fit, which scores the training rows through K3."""
    X = synth_fleet(1, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])["machine-0"]
    LSTMAutoEncoder(epochs=1, **SEQ_CONFIG).fit(X)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = LSTMAutoEncoder(epochs=SEQ_EPOCHS, **SEQ_CONFIG).fit(X)
    wall = time.perf_counter() - t0
    loss = est.history["loss"]
    if len(loss) != SEQ_EPOCHS or not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
        raise AssertionError(f"seq_train: losses {loss} are not finite or did not fall")
    k3_before = lstm_launches()
    t0 = time.perf_counter()
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("scale", MinMaxScaler()), ("model", LSTMAutoEncoder(epochs=SEQ_CHECK_EPOCHS, **SEQ_CONFIG))])).fit(X)
    det_wall = time.perf_counter() - t0
    k3_fit = lstm_launches() - k3_before
    if k3_fit <= 0:
        raise AssertionError("seq_train: the detector's fit launched no fused LSTM step")
    scored = det.anomaly(X)
    n_out = FLEET_SHAPE["rows"] - (LOOKBACK - 1)
    total = scored["total-anomaly-scaled"]
    if total.shape != (n_out,) or not np.all(np.isfinite(total)):
        raise AssertionError(f"seq_train: anomaly() gave {total.shape} or non-finite scores")
    over = float(total.max() - det.total_threshold_)
    if over > LSTM_ATOL + LSTM_RTOL * det.total_threshold_:
        raise AssertionError(f"seq_train: a training row's score exceeds the threshold by {over}")
    bs = SEQ_CONFIG["batch_size"]
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(X.shape[1])
    # with a validation split and early stopping: the validation loss is the
    # fit's only forward without a gradient, so every K3 launch of the fit is
    # one of it (epochs run x validation batches x layers) and the training
    # steps launch none
    k3_before = lstm_launches()
    val_est = LSTMAutoEncoder(epochs=SEQ_CHECK_EPOCHS, validation_split=0.2, early_stopping_patience=2,
                              **SEQ_CONFIG).fit(X)
    k3_val = lstm_launches() - k3_before
    val_loss = val_est.history["val_loss"]
    n_val = int(n_out * 0.2)
    want_k3 = len(val_loss) * -(-n_val // bs) * len(module.dims)
    if k3_val != want_k3 or len(val_loss) != len(val_est.history["loss"]):
        raise AssertionError(f"seq_train: {k3_val} fused LSTM step launches in the validated fit "
                             f"({len(val_loss)} validation losses), expected {want_k3}")
    if not np.all(np.isfinite(val_loss)):
        raise AssertionError(f"seq_train: validation losses {val_loss} are not finite")
    block = stacked_block({"machine-0": X}, bs, LOOKBACK - 1)
    prof = profile_training(train_core.StackedLSTM(module, LOOKBACK), *block, bs)
    steady = statistics.median(est.epoch_seconds_[1:])
    F32_RUNS["lstm"] = run_summary(1, wall, est.epoch_seconds_, prof)
    phase("seq_train", model="LSTMAutoEncoder", kind=SEQ_CONFIG["kind"], lookback=LOOKBACK,
          rows=len(X), tags=X.shape[1], epochs=SEQ_EPOCHS, batch=bs, dtype="float32",
          items=n_out, fit_wall_s=round(wall, 4), models_per_hour=round(3600 / wall, 1),
          epoch_s=json.dumps([round(e, 4) for e in est.epoch_seconds_]), steady_epoch_s=round(steady, 4),
          loss_epoch1=round(loss[0], 6), loss_epoch5=round(loss[-1], 6),
          detector_fit_wall_s=round(det_wall, 4), k3_launches_detector_fit=k3_fit,
          max_over_threshold=over, validated_epochs=len(val_loss),
          val_loss=json.dumps([round(v, 6) for v in val_loss]), k3_launches_validation=k3_val,
          **prof,
          epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def seq_fleet_phase(card: str):
    """FleetTrainer of config 2's model at the bench's fleet width: a warm
    1-epoch fit, then the timed fit, whose error pass runs K3."""
    members = synth_fleet(SEQ_FLEET_MEMBERS, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])
    config = dict(model_type="LSTMAutoEncoder", **SEQ_CONFIG)
    FleetTrainer(epochs=1, **config).fit(members)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = FleetTrainer(epochs=SEQ_EPOCHS, **config)
    k3_before = lstm_launches()
    t0 = time.perf_counter()
    models = trainer.fit(members)
    wall = time.perf_counter() - t0
    k3_fit = lstm_launches() - k3_before
    peak = torch.cuda.max_memory_allocated()
    bucket = trainer.last_stats["buckets"][0]
    bs = SEQ_CONFIG["batch_size"]
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(FLEET_SHAPE["n_features"])
    # no validation: every launch is the error pass, two passes of every
    # batch, one launch a layer
    want_k3 = 2 * (bucket["padded_items"] // bs) * len(module.dims)
    if k3_fit != want_k3:
        raise AssertionError(f"seq_fleet: {k3_fit} fused LSTM step launches, expected {want_k3}")
    losses = np.array([m.history["loss"] for m in models.values()])
    if losses.shape != (len(members), SEQ_EPOCHS) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"seq_fleet: loss histories of shape {losses.shape} or non-finite")
    fell = float(np.mean(losses[:, -1] < losses[:, 0]))
    if fell < 0.99:
        raise AssertionError(f"seq_fleet: the loss fell for a share of {fell} of the members, below 0.99")
    epochs = bucket["epoch_seconds"]
    steady = statistics.median(epochs[1:])
    block = stacked_block(members, bs, LOOKBACK - 1)
    prof = profile_training(train_core.StackedLSTM(module, LOOKBACK), *block, bs)
    phase("seq_fleet", members=len(members), rows=FLEET_SHAPE["rows"], tags=FLEET_SHAPE["n_features"],
          lookback=LOOKBACK, epochs=SEQ_EPOCHS, batch=bs, dtype="float32",
          padded=json.dumps({k: bucket[k] for k in ("padded_items", "padded_rows", "padded_members")}),
          fit_wall_s=round(wall, 4), models_per_hour=round(len(members) / wall * 3600, 1),
          epoch_s=json.dumps(epochs), steady_epoch_s=round(steady, 4),
          peak_device_gib=round(peak / 2**30, 3), k3_launches_error_pass=k3_fit,
          loss_fell_share=fell, loss_epoch1_median=round(float(np.median(losses[:, 0])), 6),
          loss_epoch5_median=round(float(np.median(losses[:, -1])), 6), **prof,
          epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def seq_train_parity_phase():
    """8 LSTM members of ragged rows from the same initial parameters on the
    card and on the CPU, one batch an epoch, at q = 1 and q = 0.99, and with
    a validation split and early stopping; then one member's single fit with
    the same validation and early stopping."""
    fleet = synth_fleet(8, 160, 10, seed=6)
    members = {name: X[: 160 - 8 * i] for i, (name, X) in enumerate(fleet.items())}
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(10)
    stack = train_core.StackedLSTM(module, LOOKBACK)
    initial = dict(zip(members, stack.state_dicts(stack.init(
        [train_core.member_generator(7, i) for i in range(len(members))]))))
    err = {"params": 0.0, "loss": 0.0, "val_loss": 0.0, "scalers": 0.0, "thresholds_q1": 0.0,
           "thresholds_q0.99": 0.0}
    stopped = {}  # member -> epochs run with validation and early stopping

    def hold(got, want, what, key, rtol=LSTM_RTOL, atol=LSTM_ATOL):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"seq_train_parity: {what} outside rtol={rtol}, atol={atol}")
        err[key] = max(err[key], float(np.abs(got - want).max()))

    # q = 1 and 0.99; then q = 1 with a validation split and early stopping,
    # whose validation loss runs K3 on the card: no epoch beats the first by
    # min_delta, so every member stops after epoch 2 and restores epoch 1's
    # parameters (a stop decided by a near tie could differ between the card
    # and the CPU)
    validated = dict(validation_split=0.2, early_stopping_patience=1, early_stopping_min_delta=10.0)
    for q, extra in ((1.0, {}), (0.99, {}), (1.0, validated)):
        config = dict(model_type="LSTMAutoEncoder", kind=SEQ_CONFIG["kind"], lookback_window=LOOKBACK,
                      epochs=3, batch_size=256, threshold_quantile=q)
        config.update(extra)
        card = FleetTrainer(**config).fit(members, initial_params=initial)
        cpu = FleetTrainer(device="cpu", **config).fit(members, initial_params=initial)
        for name in members:
            a, b = card[name], cpu[name]
            for k in b.params:
                hold(a.params[k], b.params[k], f"{name} {k}", "params")
            hold(a.history["loss"], b.history["loss"], f"{name} losses", "loss")
            if extra:
                hold(a.history["val_loss"], b.history["val_loss"], f"{name} validation losses", "val_loss")
                stopped[name] = len(b.history["loss"])
            for x, y in (*zip(a.scaler, b.scaler), *zip(a.error_scaler, b.error_scaler)):
                hold(x, y, f"{name} scalers", "scalers")
            if q >= 1.0:
                hold(a.feature_thresholds, b.feature_thresholds, f"{name} thresholds", "thresholds_q1")
                hold(a.total_threshold, b.total_threshold, f"{name} total threshold", "thresholds_q1")
            else:  # histogram thresholds: within two bins
                hold(a.feature_thresholds, b.feature_thresholds, f"{name} q thresholds",
                     "thresholds_q0.99", rtol=0.0, atol=2 / QUANTILE_BINS)
                hold(a.total_threshold, b.total_threshold, f"{name} q total threshold",
                     "thresholds_q0.99", rtol=0.0, atol=2 * np.sqrt(10) / QUANTILE_BINS)
            if a.threshold_method != b.threshold_method:
                raise AssertionError(f"seq_train_parity: threshold methods {a.threshold_method}, "
                                     f"{b.threshold_method}")
    # the single estimator's validation and early stopping (one member, its
    # own init and shuffles from the seed on both sides)
    name, X = next(iter(members.items()))
    single = dict(SEQ_CONFIG, batch_size=256, epochs=3, **validated)
    a = LSTMAutoEncoder(**single).fit(X)
    b = LSTMAutoEncoder(device="cpu", **single).fit(X)
    for k in b.params_:
        hold(a.params_[k], b.params_[k], f"single {k}", "params")
    for k in ("loss", "val_loss"):
        hold(a.history[k], b.history[k], f"single {k}", k if k == "val_loss" else "loss")
    stopped["single"] = len(b.history["loss"])
    if set(stopped.values()) != {2}:
        raise AssertionError(f"seq_train_parity: early stopping ran {stopped} epochs, expected 2 each")
    phase("seq_train_parity", members=len(members), rows="160..104", lookback=LOOKBACK, epochs=3,
          batch=256, quantiles="1.0,0.99", validated=json.dumps(validated),
          epochs_run_validated=json.dumps(stopped), band=f"rtol={LSTM_RTOL},atol={LSTM_ATOL}",
          q099_band="2 bins", max_abs_err=json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}))


def zoo_train_phase(card: str):
    """The reference bench's config 4 as one fit a model: the conv
    autoencoder (lookback 32) and the variational one, 1,440 rows x 10
    tags, 5 epochs, batch 128: a warm 1-epoch fit, then the timed fit; then
    each one's detector fit and its anomaly() (K1), one training step's
    device operations and host launch time, and an epoch's busy share."""
    X = synth_fleet(1, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])["machine-0"]
    bs = 128
    for family, (cls, arch) in ZOO_MODELS.items():
        cls(epochs=1, batch_size=bs, **arch).fit(X)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = cls(epochs=ZOO_EPOCHS, batch_size=bs, **arch).fit(X)
        wall = time.perf_counter() - t0
        loss = est.history["loss"]
        if len(loss) != ZOO_EPOCHS or not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
            raise AssertionError(f"zoo_train {family}: losses {loss} are not finite or did not fall")
        det = DiffBasedAnomalyDetector(base_estimator=Pipeline([
            ("scale", MinMaxScaler()), ("model", cls(epochs=ZOO_EPOCHS, batch_size=bs, **arch))])).fit(X)
        k1_before = score.launch_counts["fused_anomaly_score"]
        scored = det.anomaly(X)
        k1 = score.launch_counts["fused_anomaly_score"] - k1_before
        total = scored["total-anomaly-scaled"]
        n_out = len(X) - det.offset
        if k1 != 1 or total.shape != (n_out,) or not np.all(np.isfinite(total)):
            raise AssertionError(f"zoo_train {family}: anomaly() gave {total.shape}, K1 launched {k1} times")
        over = float(total.max() - det.total_threshold_)
        if over > LSTM_ATOL + LSTM_RTOL * det.total_threshold_:
            raise AssertionError(f"zoo_train {family}: a training row's score exceeds the threshold by {over}")
        stack = est._stack(est._build_module(X.shape[1]))
        block = stacked_block({"machine-0": X}, bs, stack.warmup)
        prof = profile_training(stack, *block, bs, loss=est._resolved_loss(stack))
        steady = statistics.median(est.epoch_seconds_[1:])
        F32_RUNS[family] = run_summary(1, wall, est.epoch_seconds_, prof)
        phase("zoo_train", family=family, model=cls.__name__, kind=est.kind,
              lookback=getattr(est, "lookback_window", 1), rows=len(X), tags=X.shape[1],
              epochs=ZOO_EPOCHS, batch=bs, dtype="float32", loss=est._resolved_loss(stack),
              params_per_member=stack.n_params, items=len(X) - stack.warmup,
              fit_wall_s=round(wall, 4), models_per_hour=round(3600 / wall, 1),
              epoch_s=json.dumps([round(e, 4) for e in est.epoch_seconds_]), steady_epoch_s=round(steady, 4),
              loss_epoch1=round(loss[0], 6), loss_epoch5=round(loss[-1], 6), k1_launches_anomaly=k1,
              max_over_threshold=over, **prof,
              epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
              card=json.dumps(card))


def zoo_fleet_phase(card: str):
    """Config 4 as a fleet at the reference bench's zoo-fleet shape (256
    members x 720 rows x 10 tags, 3 epochs, batch 128, host_sync_every=3):
    a warm fit, then the timed fit, of the conv and the variational family;
    then a bank of what each trained scores every member's training rows
    (K2): no scaled training error above its threshold (q = 1)."""
    members = synth_fleet(**ZOO_FLEET)
    names = list(members)
    for family, arch in ZOO_FLEET_MODELS.items():
        config = dict(ZOO_FLEET_CONFIG, **arch)
        FleetTrainer(**config).fit(members)  # warm
        torch.cuda.synchronize()
        trainer = FleetTrainer(**config)
        t0 = time.perf_counter()
        models = trainer.fit(members)
        wall = time.perf_counter() - t0
        losses = np.array([m.history["loss"] for m in models.values()])
        if losses.shape != (len(members), config["epochs"]) or not np.all(np.isfinite(losses)):
            raise AssertionError(f"zoo_fleet {family}: loss histories of shape {losses.shape} or non-finite")
        fell = float(np.mean(losses[:, -1] < losses[:, 0]))
        if fell < 0.99:
            raise AssertionError(f"zoo_fleet {family}: the loss fell for a share of {fell}, below 0.99")
        bucket = trainer.last_stats["buckets"][0]
        bank = ModelBank.from_entries([m.to_entry() for m in models.values()], registry=False)
        k2_before = score.launch_counts["banked_anomaly_score"]
        worst = 0.0
        for i in range(0, len(names), 64):
            chunk = names[i:i + 64]
            for name, res in zip(chunk, bank.score_many([(n, members[n], None) for n in chunk])):
                m = models[name]
                if not np.all(np.isfinite(res.total_scaled)):
                    raise AssertionError(f"zoo_fleet {family}: non-finite scores for {name}")
                over = max(float((res.scaled - m.feature_thresholds).max()),
                           float(res.total_scaled.max() - m.total_threshold))
                worst = max(worst, over)
                if over > LSTM_ATOL + LSTM_RTOL * max(m.feature_thresholds.max(), m.total_threshold):
                    raise AssertionError(f"zoo_fleet {family}: {name}'s training error exceeds its "
                                         f"threshold by {over}")
        k2 = score.launch_counts["banked_anomaly_score"] - k2_before
        phase("zoo_fleet", family=family, members=len(members), rows=ZOO_FLEET["rows"],
              tags=ZOO_FLEET["n_features"], arch=json.dumps({k: v for k, v in arch.items() if k != "model_type"}),
              params_per_member=int(sum(v.size for v in models[names[0]].params.values())),
              dtype="float32", **ZOO_FLEET_CONFIG, loss=models[names[0]].loss,
              padded=json.dumps({k: bucket[k] for k in ("padded_items", "padded_rows", "padded_members")}),
              fit_wall_s=round(wall, 4), models_per_hour=round(len(members) / wall * 3600, 1),
              epoch_s=json.dumps(bucket["epoch_seconds"]), loss_fell_share=fell,
              loss_epoch1_median=round(float(np.median(losses[:, 0])), 6),
              loss_epoch3_median=round(float(np.median(losses[:, -1])), 6),
              threshold_method=models[names[0]].threshold_method, k2_launches_serving=k2,
              max_over_threshold=worst, card=json.dumps(card))


def zoo_parity_phase():
    """8 conv and 8 variational members from the same initial parameters on
    the card and on the CPU, one batch an epoch, 3 epochs, a validation
    split of 0.2: the variational noise comes from the port's generators,
    the same numbers on both."""
    err = {}
    for family, (cls, arch) in ZOO_MODELS.items():
        members = synth_fleet(8, 256, 10, seed=8)
        est = cls(**arch)
        stack = est._stack(est._build_module(10))
        initial = dict(zip(members, stack.state_dicts(stack.init(
            [train_core.member_generator(7, i) for i in range(len(members))]))))
        fleet_arch = dict(arch, model_type=cls.__name__)
        config = dict(epochs=3, batch_size=256, validation_split=0.2, **fleet_arch)
        card = FleetTrainer(**config).fit(members, initial_params=initial)
        cpu = FleetTrainer(device="cpu", **config).fit(members, initial_params=initial)
        worst = {"params": 0.0, "loss": 0.0, "val_loss": 0.0, "scalers": 0.0, "thresholds": 0.0}

        def hold(got, want, what, key):
            got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
            if got.shape != want.shape or not np.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
                raise AssertionError(f"zoo_parity {family}: {what} outside rtol={TRAIN_RTOL}, atol={TRAIN_ATOL}")
            worst[key] = max(worst[key], float(np.abs(got - want).max()))

        for name in members:
            a, b = card[name], cpu[name]
            for k in b.params:
                hold(a.params[k], b.params[k], f"{name} {k}", "params")
            for k in ("loss", "val_loss"):
                hold(a.history[k], b.history[k], f"{name} {k}", k)
            for x, y in (*zip(a.scaler, b.scaler), *zip(a.error_scaler, b.error_scaler)):
                hold(x, y, f"{name} scalers", "scalers")
            hold(a.feature_thresholds, b.feature_thresholds, f"{name} thresholds", "thresholds")
            hold(a.total_threshold, b.total_threshold, f"{name} total threshold", "thresholds")
        err[family] = {k: float(f"{v:.3g}") for k, v in worst.items()}
    phase("zoo_parity", members="8+8", rows=256, epochs=3, batch=256, validation_split=0.2,
          band=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}", max_abs_err=json.dumps(err))


# ------------------------------------------------------------------ #
# phase 9: build a fleet and serve what it built
# ------------------------------------------------------------------ #


# ------------------------------------------------------------------ #
# bfloat16: the reference bench's bf16 legs
# ------------------------------------------------------------------ #


def bf16_launches() -> int:
    return seq_scan.launch_counts["lstm_layer_bf16"] + seq_scan.launch_counts["fused_lstm_step_bf16"]


def bf16_train_phase(card: str):
    """The reference bench's bfloat16 training legs at their own shapes
    (``bench.py:272-281``, ``:449-462``): the dense fleet, config 2's
    LSTMAutoEncoder (with a validated fit, whose forwards without a gradient
    launch K3's bfloat16 instance and nothing else), config 4's conv and
    variational autoencoders (each detector's ``anomaly()``, K1); each leg's
    numbers beside the same run's float32 phase."""
    bs = FLEET_CONFIG["batch_size"]
    members = synth_fleet(**FLEET_SHAPE)
    config = dict(FLEET_CONFIG, compute_dtype=BF16)
    FleetTrainer(**config).fit(members)  # warm
    trainer = FleetTrainer(**config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = trainer.fit(members)
    wall = time.perf_counter() - t0
    losses = np.array([m.history["loss"] for m in models.values()])
    fell = float(np.mean(losses[:, -1] < losses[:, 0]))
    if not np.all(np.isfinite(losses)) or fell < 0.99:
        raise AssertionError(f"bf16_train fleet: the loss fell for a share of {fell} of the members")
    if {m.factory_kwargs.get("compute_dtype") for m in models.values()} != {BF16}:
        raise AssertionError("bf16_train fleet: members do not carry compute_dtype=bfloat16")
    X, mask, n_real = stacked_block(members, bs)
    stack = train_core.StackedDense(lookup_factory("AutoEncoder", FLEET_CONFIG["kind"])(
        X.shape[-1], compute_dtype=BF16))
    prof = profile_training(stack, X, mask, n_real, bs)
    epochs = trainer.last_stats["buckets"][0]["epoch_seconds"]
    phase("bf16_train", leg="dense_fleet", members=len(members), rows=FLEET_SHAPE["rows"],
          tags=FLEET_SHAPE["n_features"], epochs=FLEET_CONFIG["epochs"], batch=bs, dtype=BF16,
          **run_summary(len(members), wall, epochs, prof), loss_fell_share=fell,
          epoch_device_ms=prof["epoch_device_ms"], epoch_top_device_ms=prof["epoch_top_device_ms"],
          float32=json.dumps(F32_RUNS.get("dense_fleet")), card=json.dumps(card))

    X1 = synth_fleet(1, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])["machine-0"]
    bs = SEQ_CONFIG["batch_size"]
    LSTMAutoEncoder(epochs=1, compute_dtype=BF16, **SEQ_CONFIG).fit(X1)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = LSTMAutoEncoder(epochs=SEQ_EPOCHS, compute_dtype=BF16, **SEQ_CONFIG).fit(X1)
    wall = time.perf_counter() - t0
    loss = est.history["loss"]
    if not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
        raise AssertionError(f"bf16_train lstm: losses {loss} are not finite or did not fall")
    module = est._build_module(X1.shape[1])
    k3_bf16, k3_f32 = bf16_launches(), lstm_launches()
    val_est = LSTMAutoEncoder(epochs=2, validation_split=0.2, compute_dtype=BF16, **SEQ_CONFIG).fit(X1)
    k3_bf16, k3_f32 = bf16_launches() - k3_bf16, lstm_launches() - k3_f32
    n_val = int((len(X1) - (LOOKBACK - 1)) * 0.2)
    want = len(val_est.history["val_loss"]) * -(-n_val // bs) * len(module.dims)
    if k3_bf16 != want or k3_f32 != 0:
        raise AssertionError(f"bf16_train lstm: {k3_bf16} bf16 and {k3_f32} fp32 K3 launches in the "
                             f"validated fit, expected {want} and 0")
    block = stacked_block({"machine-0": X1}, bs, LOOKBACK - 1)
    prof = profile_training(train_core.StackedLSTM(module, LOOKBACK), *block, bs)
    phase("bf16_train", leg="lstm", model="LSTMAutoEncoder", kind=SEQ_CONFIG["kind"], lookback=LOOKBACK,
          rows=len(X1), epochs=SEQ_EPOCHS, batch=bs, dtype=BF16,
          **run_summary(1, wall, est.epoch_seconds_, prof),
          loss_epoch1=round(loss[0], 6), loss_epoch5=round(loss[-1], 6),
          k3_bf16_launches_validation=k3_bf16, epoch_device_ms=prof["epoch_device_ms"],
          epoch_top_device_ms=prof["epoch_top_device_ms"],
          float32=json.dumps(F32_RUNS.get("lstm")), card=json.dumps(card))

    for family, (cls, arch) in ZOO_MODELS.items():
        cls(epochs=1, batch_size=bs, compute_dtype=BF16, **arch).fit(X1)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = cls(epochs=ZOO_EPOCHS, batch_size=bs, compute_dtype=BF16, **arch).fit(X1)
        wall = time.perf_counter() - t0
        loss = est.history["loss"]
        if not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
            raise AssertionError(f"bf16_train {family}: losses {loss} are not finite or did not fall")
        det = detector(cls(epochs=ZOO_EPOCHS, batch_size=bs, compute_dtype=BF16, **arch)).fit(X1)
        k1 = score.launch_counts["fused_anomaly_score"]
        total = det.anomaly(X1)["total-anomaly-scaled"]
        k1 = score.launch_counts["fused_anomaly_score"] - k1
        if k1 != 1 or not np.all(np.isfinite(total)):
            raise AssertionError(f"bf16_train {family}: anomaly() launched K1 {k1} times")
        stack = est._stack(est._build_module(X1.shape[1]))
        prof = profile_training(stack, *stacked_block({"machine-0": X1}, bs, stack.warmup), bs,
                                loss=est._resolved_loss(stack))
        phase("bf16_train", leg=family, model=cls.__name__, kind=est.kind, epochs=ZOO_EPOCHS, batch=bs,
              dtype=BF16, **run_summary(1, wall, est.epoch_seconds_, prof),
              loss_epoch1=round(loss[0], 6), loss_epoch5=round(loss[-1], 6), k1_launches_anomaly=k1,
              float32=json.dumps(F32_RUNS.get(family)), card=json.dumps(card))


def detector(model):
    """A min-max scaled detector around ``model`` (the reference's default
    pipeline)."""
    return DiffBasedAnomalyDetector(base_estimator=Pipeline([("scale", MinMaxScaler()), ("model", model)]))


# one bf16 fit a family, card against CPU: (estimator class, architecture)
BF16_PARITY_MODELS = {
    "dense": (AutoEncoder, dict(kind="feedforward_hourglass")),
    "vae": (AutoEncoder, dict(kind="feedforward_variational")),
    "lstm": (LSTMAutoEncoder, dict(kind="lstm_hourglass", lookback_window=LOOKBACK)),
    "conv": (ConvAutoEncoder, dict(lookback_window=LOOKBACK)),
}
# bf16 card vs CPU after three Adam steps from the same parameters, as
# tests/test_torch_bf16.py holds the port to JAX's bf16 epoch: the loss
# within rtol 1e-3; 98% of the parameters within 1e-4, every one within
# 2 * lr a step (a gradient that rounds the other way moves an Adam step by
# about its learning rate)
BF16_LOSS_RTOL = 1e-3
BF16_PARAM_ATOL, BF16_PARAM_SHARE = 1e-4, 0.98


def bf16_parity_phase():
    """One bf16 detector fit of each family on the card and on the CPU (256
    rows x 10 tags, one batch an epoch, 3 epochs, the same seed), then the
    card detectors served from a bank: its scores against each detector's
    ``anomaly()`` within TRAIN_RTOL/TRAIN_ATOL."""
    X = synth_fleet(1, 256, 10, seed=11)["machine-0"]
    lr, epochs = 1e-3, 3
    err, share, dets = {}, {}, {}
    for family, (cls, arch) in BF16_PARITY_MODELS.items():
        cfg = dict(epochs=epochs, batch_size=256, learning_rate=lr, compute_dtype=BF16, **arch)
        card = detector(cls(**cfg)).fit(X)
        cpu = detector(cls(device="cpu", **cfg)).fit(X)
        a, b = card._final_estimator, cpu._final_estimator
        if not np.allclose(a.history["loss"], b.history["loss"], rtol=BF16_LOSS_RTOL, atol=0):
            raise AssertionError(f"bf16_parity {family}: losses {a.history['loss']} vs {b.history['loss']}")
        diff = np.concatenate([np.abs(a.params_[k] - b.params_[k]).ravel() for k in b.params_])
        share[family] = float(np.mean(diff <= BF16_PARAM_ATOL))
        err[family] = float(diff.max())
        if share[family] < BF16_PARAM_SHARE or err[family] > 2 * lr * epochs:
            raise AssertionError(f"bf16_parity {family}: {share[family]} of the parameters within "
                                 f"{BF16_PARAM_ATOL}, largest error {err[family]}")
        dets[family] = card
    bank = ModelBank.from_entries([d.to_entry(f) for f, d in dets.items()], registry=False)
    if {e.compute_dtype for e in (d.to_entry() for d in dets.values())} != {BF16}:
        raise AssertionError("bf16_parity: a detector's entry lost compute_dtype")
    bank_err = 0.0
    for family, det in dets.items():
        got = bank.score(family, X).to_arrays()
        want = det.anomaly(X)
        check_arrays(got, want, f"bf16_parity bank {family}", rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        bank_err = max(bank_err, max(float(np.abs(got[k] - want[k]).max()) for k in want))
    phase("bf16_parity", families=",".join(dets), rows=256, epochs=epochs, batch=256, lr=lr,
          band=json.dumps(f"loss rtol={BF16_LOSS_RTOL}; params {BF16_PARAM_SHARE} within "
                          f"{BF16_PARAM_ATOL}, all within 2*lr*steps"),
          params_share_within=json.dumps(share), params_max_err=json.dumps(err),
          bank_vs_anomaly_band=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}", bank_vs_anomaly_max_err=bank_err)


def bf16_bank_phase(card: str):
    """The LSTM bank of ``bench.py:1286-1295``'s model in bf16 (10,000
    ``lstm_hourglass`` members, lookback 32, 128-row requests) and a dense
    bf16 bank, each through the closed loop and one profiled batch; then a
    bank of bf16 and fp32 twins of equal kwargs: two buckets a family, each
    bf16 member's scores equal to its ``anomaly()`` on the card within
    TRAIN_RTOL/TRAIN_ATOL, and apart from its fp32 twin's."""
    bank_phase(card, "lstm", BF16)
    bank_phase(card, "dense", BF16)
    rng = np.random.default_rng(12)
    entries = []
    for i in range(16):
        e = random_entry(f"d{i}", 10, rng)
        entries += [e, dataclasses.replace(e, name=f"d{i}-bf16", compute_dtype=BF16)]
    for i in range(8):
        e = random_lstm_entry(f"l{i}", "LSTMAutoEncoder", rng)
        entries += [e, dataclasses.replace(e, name=f"l{i}-bf16", compute_dtype=BF16)]
    bank = ModelBank.from_entries(entries, registry=False)
    if bank.n_buckets != 4:
        raise AssertionError(f"bf16_mixed_bank: {bank.n_buckets} buckets for 2 families x 2 dtypes")
    X = rng.random((128, 10)).astype(np.float32)
    err = apart = 0.0
    for e in entries:
        if e.compute_dtype != BF16:
            continue
        got = bank.score(e.name, X).to_arrays()
        want = DiffBasedAnomalyDetector.from_entry(e).anomaly(X)
        check_arrays(got, want, f"bf16_mixed_bank {e.name}", rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        err = max(err, max(float(np.abs(got[k] - want[k]).max()) for k in want))
        twin = bank.score(e.name.removesuffix("-bf16"), X).to_arrays()["model-output"]
        apart = max(apart, float(np.abs(twin - got["model-output"]).max()))
    if apart <= 0:
        raise AssertionError("bf16_mixed_bank: bf16 members score as their fp32 twins")
    phase("bf16_mixed_bank", members=len(entries), buckets=bank.n_buckets,
          labels=json.dumps(sorted(b.label for b in bank._buckets.values())),
          band=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}", bank_vs_anomaly_max_err=err,
          bf16_vs_fp32_twin_max_diff=apart)


def detector_pipeline(model_type: str, **kwargs):
    return {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {f"gordo_components_torch.models.{model_type}": kwargs}]}}}}


def dataset(name, tags=10):
    """A RandomDataset of 7 days at 10 min (1,008 rows)."""
    return {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-08T00:00:00Z",
            "tag_list": [f"{name}-tag-{j}" for j in range(tags)]}


BUILD_MACHINES = 16  # RandomDataset machines of the build phase, cut from 64, then 32 (the smoke's wall)


def build_phase():
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    out_dir, reg_dir = os.path.join(FLEET_DIR, "models"), os.path.join(FLEET_DIR, "register")

    machines = [Machine(name=f"fleet-{i:03d}", dataset=dataset(f"fleet-{i:03d}")) for i in range(BUILD_MACHINES)]
    # a bare AutoEncoder (no scaler step) is not fleetable: the single-build path
    machines.append(Machine(name="bespoke", dataset=dataset("bespoke"), model={
        "gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "gordo_components_torch.models.AutoEncoder": {"kind": "feedforward_hourglass"}}}}))
    # examples/fleet.yaml's LSTM machine, as its dict
    machines.append(Machine.from_dict({
        "name": "turbine-lstm",
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
                    "train_end_date": "2020-01-08T00:00:00Z", "tag_list": ["tl-vibration", "tl-load"]},
        "model": {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_components_tpu.models.LSTMAutoEncoder": {
                    "kind": "lstm_hourglass", "lookback_window": 12, "epochs": 5}}]}}}},
    }))
    lstm_types = {f"lae-{i}": "LSTMAutoEncoder" for i in range(4)} | {f"lfc-{i}": "LSTMForecast" for i in range(2)}
    machines += [Machine(name=n, dataset=dataset(n), model=detector_pipeline(t, kind="lstm_hourglass"))
                 for n, t in lstm_types.items()]
    # config 4 at the default estimator configs: two conv machines and two
    # variational ones (two more gangs)
    zoo_models = {"conv-0": detector_pipeline("ConvAutoEncoder"), "conv-1": detector_pipeline("ConvAutoEncoder"),
                  "vae-0": detector_pipeline("AutoEncoder", kind="feedforward_variational"),
                  "vae-1": detector_pipeline("AutoEncoder", kind="feedforward_variational")}
    machines += [Machine(name=n, dataset=dataset(n), model=m) for n, m in zoo_models.items()]
    # an LSTM detector without a scaler step: the single-build path
    machines.append(Machine(name="bespoke-lstm", dataset=dataset("bespoke-lstm"), model={
        "gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "gordo_components_torch.models.LSTMForecast": {
                "kind": "lstm_hourglass", "lookback_window": 16, "epochs": 3}}}}))
    # top-level configs that are not detectors: single builds, written as
    # model.json, served on the per-model path
    not_detectors = {
        "c1-pipeline": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler", "gordo_components_torch.models.AutoEncoder"]}},
        "c1-estimator": {"gordo_components_torch.models.AutoEncoder": {}},
    }
    machines += [Machine(name=n, dataset=dataset(n), model=m) for n, m in not_detectors.items()]
    lstm_names = {"turbine-lstm", "bespoke-lstm", *lstm_types}
    banded = lstm_names | set(zoo_models)  # held in the LSTM band
    engine = None
    try:
        t0 = time.perf_counter()
        report = build_fleet(machines, out_dir, model_register_dir=reg_dir)
        build_s = time.perf_counter() - t0
        manifest = report.manifest()
        if manifest["n_built"] != len(machines) or report.failed:
            raise AssertionError(f"build: {manifest['n_built']} built, failed {report.failed}")
        collection = ModelCollection(out_dir)
        bank = ModelBank.from_models(collection.models, registry=False)
        if sorted(bank.fallback) != sorted(not_detectors) or bank.finalize_failures:
            raise AssertionError(f"build: the bank left out {bank.fallback} {bank.finalize_failures}")
        engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
        engine.start()
        data = {m.name: get_dataset(m.dataset).get_data()[0].values for m in machines}
        for name in not_detectors:
            out = collection.models[name].predict(data[name])
            if out.shape != data[name].shape or not np.all(np.isfinite(out)):
                raise AssertionError(f"build: {name} predicted {out.shape} or non-finite values")
        results = {name: engine.score_blocking(name, X, timeout=120) for name, X in data.items()
                   if name not in not_detectors}
        worst = 0.0
        for name, res in results.items():
            arrays = res.to_arrays()
            if not all(np.all(np.isfinite(a)) for a in arrays.values()):
                raise AssertionError(f"build: non-finite scores for {name}")
            th = collection.metadata[name]["thresholds"]
            feat = np.array([th["feature-thresholds"][t] for t in collection.models[name].tags_])
            over = max(float((res.scaled - feat).max()),
                       float(res.total_scaled.max() - th["total-anomaly-threshold"]))
            worst = max(worst, over)
            band = LSTM_ATOL + LSTM_RTOL * max(feat.max(), th["total-anomaly-threshold"]) \
                if name in banded else E2E_ATOL
            if over > band:
                raise AssertionError(f"build: {name}'s training error exceeds its threshold by {over}")
        zoo_k1 = 0
        for name in results:
            k1_before = score.launch_counts["fused_anomaly_score"]
            got = serializer.load(os.path.join(out_dir, name)).anomaly(data[name])
            if name in zoo_models:
                zoo_k1 += score.launch_counts["fused_anomaly_score"] - k1_before
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if name in banded else {}
            check_arrays(got, results[name].to_arrays(), f"build {name}: anomaly() vs bank", **band)
        # the config-4 machines alone through the bank: K2 once a bucket
        k2_before = score.launch_counts["banked_anomaly_score"]
        bank.score_many([(n, data[n], None) for n in zoo_models])
        zoo_k2 = score.launch_counts["banked_anomaly_score"] - k2_before
        if zoo_k1 != len(zoo_models) or zoo_k2 != 2:
            raise AssertionError(f"build: config-4 machines launched K1 {zoo_k1} and K2 {zoo_k2} times")
        zoo_types = {n: collection.metadata[n]["registry_type"] for n in zoo_models}
    finally:
        if engine is not None:
            engine.stop()
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    phase("build", machines=len(machines), n_built=manifest["n_built"], n_failed=manifest["n_failed"],
          per_model=json.dumps(sorted(not_detectors)), lstm_machines=len(lstm_names),
          zoo_machines=json.dumps(zoo_types), zoo_k1_launches=zoo_k1, zoo_k2_launches=zoo_k2,
          build_s=round(build_s, 3), rows_per_machine=len(data["fleet-000"]),
          bank_buckets=bank.n_buckets, scored="every detector by the bank and by anomaly(), the rest by predict()",
          max_over_threshold=worst)


# ------------------------------------------------------------------ #
# phase 10: the port's own CLI, as subprocesses on the card
# ------------------------------------------------------------------ #


# ``python -m gordo_components_torch.cli ARGS`` run in a fresh interpreter
# (from the repo's root, so this script imports) with ``import pyarrow``
# blocked, which writes, as it exits, its kernel launch counts (from 0 at its
# start), the shapes of its kernel calls on the card (record_path_shapes) and
# whether pyarrow stayed out (``pyarrow_blocked``) to the file named first in
# its arguments
COUNTED_CLI = r"""
import importlib.abc, json, runpy, sys


class NoPyarrow(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "pyarrow":
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, NoPyarrow())
import chip_smoke
from gordo_components_torch.ops import score, seq_scan
out = sys.argv.pop(1)
chip_smoke.record_path_shapes()
try:
    runpy.run_module("gordo_components_torch.cli", run_name="__main__", alter_sys=True)
finally:
    try:
        import pyarrow  # noqa: F401
        blocked = False
    except ImportError:
        blocked = not any(n.split(".")[0] == "pyarrow" for n in sys.modules)
    with open(out, "w") as f:
        json.dump({"counts": dict(score.launch_counts, **seq_scan.launch_counts),
                   "shapes": {k: sorted(v) for k, v in chip_smoke.PATH_SHAPES.items()},
                   "pyarrow_blocked": blocked}, f)
"""


def cli_command(run: str, args, counts_dir: str = CLI_DIR):
    """The command line of one counted CLI run named ``run``."""
    return [sys.executable, "-c", COUNTED_CLI, os.path.join(counts_dir, f"{run}.counts.json"),
            "--device", CLI_DEVICE, *args]


def cli(run: str, args, env=None, counts_dir: str = CLI_DIR):
    """One counted CLI run within the deadline; its CompletedProcess."""
    return subprocess.run(cli_command(run, args, counts_dir), cwd=ROOT, env=dict(os.environ, **(env or {})),
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S)


def cli_counts(run: str, counts_dir: str = CLI_DIR) -> dict:
    """A finished CLI run's launch counts; its kernel shapes join PATH_SHAPES.
    Raises if pyarrow imported in it."""
    with open(os.path.join(counts_dir, f"{run}.counts.json")) as f:
        read = json.load(f)
    if not read["pyarrow_blocked"]:
        raise AssertionError(f"cli run {run}: pyarrow imported, though blocked")
    for name, shapes in read["shapes"].items():
        PATH_SHAPES[name].update(tuple(shape) for shape in shapes)
    return read["counts"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_server(server) -> None:
    """SIGTERM a CLI ``run-server``; kill it if it does not stop in a minute."""
    if server.poll() is None:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()


def wait_for_models(base: str, server, t0: float):
    """The first answer of a CLI server's ``/models``."""
    while True:
        try:
            return http_json(base + "/models")
        except OSError:
            if server.poll() is not None or time.perf_counter() - t0 > CLI_TIMEOUT_S:
                raise AssertionError(f"cli run-server did not answer (exit {server.poll()})") from None
            time.sleep(0.5)


CLI_CLIENT_RANGE = ("2020-01-01T00:00:00Z", "2020-01-03T00:00:00Z")  # 288 rows at 10 min
CLI_CLIENT_BATCH = 100  # rows a chunk, past turbine-lstm's lookback of 12


def archive_members(data: bytes):
    """An artifact archive's members by name; ``detector.json`` (or
    ``model.json``) without its ``stamp``, which every dump writes anew."""
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        out = {m.name: tar.extractfile(m).read() for m in tar.getmembers() if m.isfile()}
    for name in ("detector.json", "model.json"):
        if name in out:
            desc = json.loads(out[name])
            desc.pop("stamp", None)
            out[name] = desc
    return out


def cli_client(url: str, out_dir: str, fleet: dict, runs: dict) -> dict:
    """The CLI's ``client`` commands against its own ``run-server``:
    ``metadata`` (every target's, as ``/metadata`` answers it), ``predict
    --parquet-dir`` (each file read back with the port's reader and held
    against the detector's ``anomaly()`` here, a chunk at a time) and
    ``download-model`` (the route's archive)."""
    common = ["--project", "smoke", "--base-url", url]
    predictions = os.path.join(CLI_DIR, "predictions")
    dest = os.path.join(CLI_DIR, "compressor-a.model")
    # the three commands at once: each reads the server only
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        metadata = pool.submit(cli, "client_metadata", ["client", "metadata", *common])
        predict = pool.submit(cli, "client_predict", ["client", "predict", *CLI_CLIENT_RANGE, *common,
                                                      "--parquet-dir", predictions,
                                                      "--batch-size", str(CLI_CLIENT_BATCH)])
        download = pool.submit(cli, "client_download", ["client", "download-model", "compressor-a", dest, *common])
    proc = metadata.result()
    meta = json.loads(proc.stdout) if proc.returncode == 0 else {}
    if sorted(meta) != sorted(fleet) or any(
            meta[n] != http_json(f"{url}/gordo/v0/smoke/{n}/metadata")[1]["endpoint-metadata"] for n in fleet):
        raise AssertionError(f"cli client metadata exited {proc.returncode}: {proc.stdout[:500]} {proc.stderr[-1000:]}")
    runs["client_metadata"] = cli_counts("client_metadata")
    proc = predict.result()
    if proc.returncode != 0 or proc.stdout.strip() != f"{len(fleet)}/{len(fleet)} machines scored successfully":
        raise AssertionError(f"cli client predict exited {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
    runs["client_predict"] = cli_counts("client_predict")
    rows = {}
    for name, machine in fleet.items():
        index, columns, values = read_parquet(os.path.join(predictions, f"{name}.parquet"))
        want, want_index = client_reference(machine["dataset"], CLI_CLIENT_RANGE, CLI_CLIENT_BATCH,
                                            {name: os.path.join(out_dir, name)})[name]
        names = ["|".join(c for c in col if c) for col in client_columns(machine["dataset"]["tag_list"])]
        got = np.column_stack([values[c] for c in columns]) if columns == names else None
        band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if "model" in machine else {"rtol": 0.0, "atol": E2E_ATOL}
        if got is None or not np.array_equal(index, want_index) or not np.allclose(
                got, want.astype(np.float64), **band):
            raise AssertionError(f"cli client predict: {name}'s parquet file: columns {columns[:3]}..., "
                                 f"{None if got is None else got.shape} against {want.shape}")
        rows[name] = len(index)
    proc = download.result()
    route = get_bytes(f"{url}/gordo/v0/smoke/compressor-a/download-model")
    with open(dest, "rb") as f:
        got = f.read()
    if proc.returncode != 0 or proc.stdout.strip() != dest or archive_members(got) != archive_members(route):
        raise AssertionError(f"cli client download-model exited {proc.returncode}: {proc.stderr[-1000:]}")
    runs["client_download"] = cli_counts("client_download")
    return {"client_predict_rows": rows, "client_download_bytes": len(got), "client_metadata_targets": len(meta)}


def workflow_cli(args):
    """One ``workflow`` command of the CLI in a subprocess (it moves no
    tensor, so it runs uncounted); its CompletedProcess."""
    return subprocess.run([sys.executable, "-m", "gordo_components_torch.cli", "workflow", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S)


def cli_workflow() -> dict:
    """examples/fleet.yaml through ``workflow compile`` twice and ``workflow
    generate`` once: each exits 0 and the two DAGs are byte-equal (``workflow
    run`` is the ``workflow`` step's). Returns the readings."""
    out, seconds = {}, {}
    for run in ("compile_1", "compile_2", "generate"):
        command = "generate" if run == "generate" else "compile"
        out[run] = os.path.join(CLI_DIR, f"workflow_{run}.out")
        t = time.perf_counter()
        proc = workflow_cli([command, "-f", FLEET_YAML, "-p", "smoke", "-o", out[run]])
        seconds[run] = round(time.perf_counter() - t, 3)
        if proc.returncode != 0 or proc.stdout.strip() != out[run]:
            raise AssertionError(f"cli workflow {command} exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out["compile_1"], "rb") as a, open(out["compile_2"], "rb") as b:
        dag, again = a.read(), b.read()
    if dag != again:
        raise AssertionError("cli workflow compile: two compiles of one spec differ")
    counts = json.loads(dag)["counts"]
    if counts != {"bucket": 2, "build": 3, "canary": 1, "place": 1, "promote": 1}:
        raise AssertionError(f"cli workflow compile: {counts}")
    with open(out["generate"]) as f:
        manifest = f.read()
    jobs = manifest.count("\nkind: Job\n")
    if jobs != counts["bucket"] or "GORDO_SLO_OBJECTIVES" not in manifest:
        raise AssertionError(f"cli workflow generate: {jobs} Jobs for {counts['bucket']} buckets")
    return {"dag_bytes": len(dag), "dag_sha256": hashlib.sha256(dag).hexdigest()[:16], "jobs": jobs,
            "manifest_bytes": len(manifest.encode()), "seconds": seconds}


def cli_phase():
    """examples/fleet.yaml through ``build-fleet`` and ``run-server``, one
    anomaly POST a machine held against its detector's ``anomaly()`` here;
    ``build`` with cross-validation; the exit codes 81 and 84;
    ``workflow compile`` twice and ``workflow generate``
    (``cli_workflow``). Returns the
    launch counts of the CLI runs, summed: this process's launches (the
    ``anomaly()`` checks) are not the CLI's."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    out_dir = os.path.join(CLI_DIR, "fleet")
    with open(FLEET_YAML) as f:
        fleet = {m["name"]: m for m in safe_load(f)["machines"]}
    runs = {}
    data_config = json.dumps(fleet["compressor-a"]["dataset"])
    env = {"MACHINE_NAME": "compressor-a", "MODEL_CONFIG": json.dumps(DEFAULT_MODEL_CONFIG),
           "DATA_CONFIG": data_config, "OUTPUT_DIR": os.path.join(CLI_DIR, "single"),
           "EVALUATION_CONFIG": '{"cross_validation": true, "n_splits": 3}'}
    payload = os.path.join(CLI_DIR, "partial.json")
    with open(payload, "w") as f:
        json.dump({"machines": [fleet["compressor-a"],
                                {"name": "ghost", "dataset": fleet["compressor-a"]["dataset"],
                                 "model": {"no.such.Model": {}}}]}, f)
    # the runs that need no server go beside build-fleet and run-server
    side = concurrent.futures.ThreadPoolExecutor(4)
    build_cv = side.submit(cli, "build_cv", ["build", "--print-cv-scores"], env=env)
    build_unparsable = side.submit(cli, "build_unparsable", ["build"], env=dict(env, MODEL_CONFIG="{unclosed: [1, 2"))
    build_partial = side.submit(cli, "build_partial", ["build-fleet", "--machines-file", payload,
                                                       "--output-dir", os.path.join(CLI_DIR, "partial")])
    workflow = side.submit(cli_workflow)
    try:
        client, build_s, serve_s, server = cli_serve(fleet, out_dir, runs)
    finally:
        side.shutdown()
    proc = build_cv.result()
    if proc.returncode != 0:
        raise AssertionError(f"cli build exited {proc.returncode}: {proc.stderr[-2000:]}")
    folds = json.loads(proc.stdout.splitlines()[0])["per-fold"]
    if len(folds) != 3 or not np.all(np.isfinite(folds)):
        raise AssertionError(f"cli build --print-cv-scores printed {folds}")
    runs["build_cv"] = cli_counts("build_cv")
    proc = build_unparsable.result()
    if proc.returncode != 81:
        raise AssertionError(f"cli build of a config that does not parse exited {proc.returncode}, not 81")
    runs["build_unparsable"] = cli_counts("build_unparsable")
    proc = build_partial.result()
    partial = json.loads(proc.stdout) if proc.stdout.strip() else {}
    if proc.returncode != 84 or sorted(partial.get("failed", {})) != ["ghost"]:
        raise AssertionError(f"cli build-fleet of a partial payload exited {proc.returncode}: {partial}")
    runs["build_partial"] = cli_counts("build_partial")
    workflow = workflow.result()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    # turbine-lstm's error passes in build-fleet, and every POST scored by
    # its bucket behind run-server (the LSTM bucket's layers too)
    if runs["build_fleet"]["lstm_layer"] <= 0 or runs["run_server"]["lstm_layer"] <= 0:
        raise AssertionError(f"cli: an LSTM path launched no lstm_layer: {runs}")
    if runs["run_server"]["banked_anomaly_score"] < len(fleet):
        raise AssertionError(f"cli run-server: {len(fleet)} POSTs, banked launches {runs}")
    phase("cli", built=json.dumps(sorted(fleet)), build_fleet_s=round(build_s, 3),
          server_ready_s=round(serve_s, 3), posts=len(fleet), checked="all six arrays vs anomaly() here",
          server_exit_on_sigterm=server.returncode, cv_folds=json.dumps(folds), exit_unparsable=81,
          exit_partial=84, partial_failed=json.dumps(sorted(partial["failed"])),
          client=json.dumps(client), workflow=json.dumps(workflow), launches_by_run=json.dumps(runs))
    return {k: sum(c[k] for c in runs.values()) for k in runs["build_fleet"]}


def cli_serve(fleet: dict, out_dir: str, runs: dict) -> tuple:
    """``build-fleet`` of examples/fleet.yaml into ``out_dir``, then
    ``run-server`` over it: one anomaly POST a machine held against its
    detector's ``anomaly()`` here, and the ``client`` commands
    (``cli_client``); (client readings, build s, server-ready s, the
    stopped server)."""
    t0 = time.perf_counter()
    proc = cli("build_fleet", ["build-fleet", "--machines-file", FLEET_YAML, "--output-dir", out_dir])
    build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli build-fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
    manifest = json.loads(proc.stdout)
    if sorted(manifest["built"]) != sorted(fleet) or manifest["failed"]:
        raise AssertionError(f"cli build-fleet: {manifest}")
    runs["build_fleet"] = cli_counts("build_fleet")

    port = free_port()
    log = open(os.path.join(CLI_DIR, "server.log"), "w")
    t1 = time.perf_counter()
    server = subprocess.Popen(
        cli_command("run_server", ["run-server", "--model-dir", out_dir, "--host", "127.0.0.1",
                                   "--port", str(port)]),
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
    )
    try:
        base = f"http://127.0.0.1:{port}/gordo/v0/smoke"
        status, models = wait_for_models(base, server, t1)
        serve_s = time.perf_counter() - t1
        if status != 200 or models["models"] != sorted(fleet):
            raise AssertionError(f"cli run-server /models answered {status}: {models}")
        for name, machine in fleet.items():
            X = get_dataset(machine["dataset"]).get_data()[0].values
            status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})
            if status != 200:
                raise AssertionError(f"cli run-server: {name} answered {status}: {body}")
            want = serializer.load(os.path.join(out_dir, name)).anomaly(X)
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if "model" in machine else {}
            check_arrays(response_arrays(body, machine["dataset"]["tag_list"]), want, f"cli {name}", **band)
        client = cli_client(f"http://127.0.0.1:{port}", out_dir, fleet, runs)
    finally:
        stop_server(server)
        log.close()
    if server.returncode != 0:
        raise AssertionError(f"cli run-server exited {server.returncode} on SIGTERM")
    runs["run_server"] = cli_counts("run_server")
    return client, build_s, serve_s, server


# ------------------------------------------------------------------ #
# phase 11: cross-validation in the fleet build
# ------------------------------------------------------------------ #


def cv_machines():
    ev = dict(CV_EVALUATION)
    dense = [Machine(name=f"cvd-{i:03d}", dataset=dataset(f"cvd-{i:03d}"), evaluation=dict(ev))
             for i in range(CV_MEMBERS["dense"])]
    lstm_model = detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=LOOKBACK,
                                   epochs=CV_LSTM_EPOCHS)
    lstm = [Machine(name=f"cvl-{i}", dataset=dataset(f"cvl-{i}"), model=lstm_model, evaluation=dict(ev))
            for i in range(CV_MEMBERS["lstm"])]
    return dense, lstm


def cv_phase(card: str):
    """``build_fleet`` of 16 dense and 4 LSTM machines, each cross-validated
    in its gang, and one ``cross_val_only`` machine; then the first machine
    of each family single-built, its folds against the gang's."""
    shutil.rmtree(CV_DIR, ignore_errors=True)
    out_dir, reg_dir = os.path.join(CV_DIR, "models"), os.path.join(CV_DIR, "register")
    dense, lstm = cv_machines()
    only = Machine(name="cv-only", dataset=dataset("cv-only"),
                   evaluation={"cv_mode": "cross_val_only", "n_splits": 3})
    machines = dense + lstm + [only]
    scoring = {"k3": 0, "seconds": 0.0}
    real_score = fleet_build._score_cv_folds

    def counted(plan, models):  # K3's launches while the folds score
        before, t = lstm_launches(), time.perf_counter()
        try:
            return real_score(plan, models)
        finally:
            scoring["k3"] += lstm_launches() - before
            scoring["seconds"] += time.perf_counter() - t

    fleet_build._score_cv_folds = counted
    try:
        t0 = time.perf_counter()
        report = build_fleet(machines, out_dir, model_register_dir=reg_dir)
        wall = time.perf_counter() - t0
    finally:
        fleet_build._score_cv_folds = real_score
    try:
        if sorted(report) != sorted(m.name for m in machines) or report.failed:
            raise AssertionError(f"cv: built {len(report)}, failed {report.failed}")
        fold_members = {}
        for m in dense + lstm:
            md = serializer.load_metadata(report[m.name])["model"]
            cv = md["cross-validation"]
            for metric in ("explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error"):
                folds = cv[metric]["per-fold"]
                if len(folds) != 3 or not np.all(np.isfinite(folds)):
                    raise AssertionError(f"cv: {m.name} {metric} folds {folds}")
            if cv.get("fleet_cv") is not True:
                raise AssertionError(f"cv: {m.name} was not cross-validated in its gang")
            fold_members[m.name[:3]] = md["fleet_stats"].get("cv_fold_members")
        want = {"cvd": 3 * len(dense), "cvl": 3 * len(lstm)}
        if fold_members != want:
            raise AssertionError(f"cv: fold members {fold_members}, expected {want}")
        md = serializer.load_metadata(report["cv-only"])["model"]
        key = calculate_model_key(only.name, only.model, only.dataset, only.metadata)
        served = ModelCollection(out_dir).names()
        if (md["trained"] or len(md["cross-validation"]["explained-variance"]["per-fold"]) != 3
                or os.path.exists(os.path.join(reg_dir, key)) or "cv-only" in served
                or len(served) != len(dense) + len(lstm)):
            raise AssertionError("cv: the cross_val_only machine was trained, registered or served")
        if scoring["k3"] <= 0:
            raise AssertionError("cv: the LSTM folds scored without the fused step")
        # gang vs single build: the first machine of each family, its folds
        # cross-validated alone (cross_val_only: the same folds, no final
        # fit). Its first gang member starts from the single build's initial
        # parameters and shuffles, so every fold's four metrics are held
        # within the training bands
        gaps = {}
        for m, rtol, atol in ((dense[0], TRAIN_RTOL, TRAIN_ATOL), (lstm[0], LSTM_RTOL, LSTM_ATOL)):
            single = provide_saved_model(
                m.name, m.model, m.dataset, m.metadata, output_dir=os.path.join(CV_DIR, "single", m.name),
                evaluation_config={"cv_mode": "cross_val_only", "n_splits": 3})
            cv_single, cv_gang = (serializer.load_metadata(path)["model"]["cross-validation"]
                                  for path in (single, report[m.name]))
            gaps[m.name] = {}
            for metric in ("explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error"):
                a, b = (np.asarray(cv[metric]["per-fold"]) for cv in (cv_single, cv_gang))
                if a.shape != (3,) or not np.allclose(b, a, rtol=rtol, atol=atol):
                    raise AssertionError(f"cv: {m.name}'s gang folds {b} and single folds {a} ({metric}) "
                                         f"part beyond rtol={rtol}, atol={atol}")
                gaps[m.name][metric] = float(np.abs(a - b).max())
    finally:
        shutil.rmtree(CV_DIR, ignore_errors=True)
    phase("cv", machines=len(machines), gang_dense=len(dense), gang_lstm=len(lstm), n_splits=3,
          rows=1008, tags=10, lookback=LOOKBACK, fold_members=json.dumps(fold_members),
          build_s=round(wall, 3), models_per_hour=round(len(machines) / wall * 3600, 1),
          fold_scoring_s=round(scoring["seconds"], 3), k3_launches_fold_scoring=scoring["k3"],
          cross_val_only="untrained,unregistered,unserved", gang_vs_single_max_gap=json.dumps(gaps),
          gap_band_dense=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}",
          gap_band_lstm=f"rtol={LSTM_RTOL},atol={LSTM_ATOL}", card=json.dumps(card))


def cv_parity_phase():
    """8 dense and 4 LSTM machines of the cv phase: the fold plan, the fold
    members' training from the same initial parameters (one batch an
    epoch, 3 epochs) and their scores, on the card and on the CPU."""
    dense, lstm = cv_machines()
    err = {}
    for family, machines, kwargs, rtol, atol in (
            ("dense", dense[:8], {"kind": "feedforward_hourglass"}, TRAIN_RTOL, TRAIN_ATOL),
            ("lstm", lstm[:4], {"kind": "lstm_hourglass", "lookback_window": LOOKBACK,
                                "model_type": "LSTMAutoEncoder"}, LSTM_RTOL, LSTM_ATOL)):
        data = {m.name: get_dataset(m.dataset).get_data()[0] for m in machines}
        module = lookup_factory(kwargs.get("model_type", "AutoEncoder"), kwargs["kind"])(10)
        stack = (train_core.StackedLSTM(module, LOOKBACK) if family == "lstm"
                 else train_core.StackedDense(module))
        plans, scores = {}, {}
        for device in ("cuda", "cpu"):
            plan, fold_data, infeasible = fleet_build._plan_cv_folds(machines, data, kwargs)
            if infeasible:
                raise AssertionError(f"cv_parity: infeasible {[m.name for m in infeasible]}")
            initial = dict(zip(fold_data, stack.state_dicts(stack.init(
                [train_core.member_generator(7, i) for i in range(len(fold_data))]))))
            models = FleetTrainer(device=device, epochs=3, batch_size=1024, **kwargs).fit(
                fold_data, initial_params=initial)
            plans[device] = {n: [(tr.tolist(), te.tolist()) for tr, te in sp] for n, (sp, _X) in plan.items()}
            scores[device] = fleet_build._score_cv_folds(plan, models)
        if plans["cuda"] != plans["cpu"]:
            raise AssertionError(f"cv_parity: {family} fold indices differ between the card and the CPU")
        worst = 0.0
        for name, got in scores["cuda"].items():
            for metric in ("explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error"):
                a = np.asarray(got[metric]["per-fold"])
                b = np.asarray(scores["cpu"][name][metric]["per-fold"])
                if not np.allclose(a, b, rtol=rtol, atol=atol):
                    raise AssertionError(f"cv_parity: {name} {metric} {a} (card) vs {b} (CPU)")
                worst = max(worst, float(np.abs(a - b).max()))
        err[family] = float(f"{worst:.3g}")
    phase("cv_parity", dense=8, lstm=4, folds=3, epochs=3, batch=1024,
          band_dense=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}", band_lstm=f"rtol={LSTM_RTOL},atol={LSTM_ATOL}",
          fold_indices="equal", max_abs_err=json.dumps(err))


# ------------------------------------------------------------------ #
# phase 12: a mixed collection: detectors in the bank, bare models on the
# per-model path, the collection routes and a reload under load
# ------------------------------------------------------------------ #


COLLECTION_DIR = os.path.join(ROOT, "build", "chip_smoke_collection")
COLLECTION_LOOKBACK = 10
COLLECTION_EPOCHS = 3
_EST = "gordo_components_torch.models"
COLLECTION_MODELS = {
    "dense-det": detector_pipeline("AutoEncoder", kind="feedforward_hourglass", epochs=COLLECTION_EPOCHS),
    "lstm-det": detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass",
                                  lookback_window=COLLECTION_LOOKBACK, epochs=COLLECTION_EPOCHS),
    "bare-ae": {f"{_EST}.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": COLLECTION_EPOCHS}},
    "bare-pipe": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {f"{_EST}.LSTMAutoEncoder": {"kind": "lstm_hourglass", "lookback_window": COLLECTION_LOOKBACK,
                                     "epochs": COLLECTION_EPOCHS}}]}},
}
COLLECTION_FALLBACK = {"bare-ae": "not a DiffBasedAnomalyDetector (AutoEncoder)",
                       "bare-pipe": "not a DiffBasedAnomalyDetector (Pipeline)"}
COLLECTION_ROWS = 128  # rows a request


def launches() -> dict:
    return {"K1": score.launch_counts["fused_anomaly_score"], "K2": score.launch_counts["banked_anomaly_score"],
            "K3": seq_scan.launch_counts["lstm_layer"]}


def launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def serve_collection(out_dir: str, use_bank):
    server = run_server(out_dir, host="127.0.0.1", port=0, background=True, use_bank=use_bank)
    return server, server.url + "/gordo/v0/smoke"


def get_bytes(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url} answered {resp.status}")
        return resp.read()


def rewrite_under_reload(base: str, out_dir: str, name: str, X) -> dict:
    """Rebuild the served detector ``name`` into its directory twice, once
    through ``serializer.dump`` and once through the build cache's mirror,
    while a thread POSTs to it and calls ``/reload`` without pause: every
    answer 200, no reload reports it removed, and once both are done its
    answers equal the mirrored build's ``anomaly()``."""
    served = os.path.join(out_dir, name)
    register = os.path.join(COLLECTION_DIR, "register")
    statuses, reloads, stop = [], [], threading.Event()

    def churn():
        while not stop.is_set():
            statuses.append(http_json(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})[0])
            status, body = http_json(base + "/reload", {})
            statuses.append(status)
            reloads.append(body.get("changes", {}))

    thread = threading.Thread(target=churn)
    thread.start()
    try:
        model, metadata = build_model(name, COLLECTION_MODELS["dense-det"], dataset("rewrite-a"))
        serializer.dump(model, served, metadata=metadata)
        time.sleep(0.2)
        provide_saved_model(name, COLLECTION_MODELS["dense-det"], dataset("rewrite-b"),
                            output_dir=served, model_register_dir=register)
        time.sleep(0.2)
    finally:
        stop.set()
        thread.join()
    status, last = http_json(base + "/reload", {})
    removed = [c for c in reloads + [last.get("changes", {})] if name in c.get("removed", [])]
    if not statuses or set(statuses) != {200} or status != 200 or removed:
        raise AssertionError(f"collection rewrite: answers {sorted(set(statuses))}, reloads that removed "
                             f"{name}: {removed}")
    status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})
    built = serializer.load(os.path.join(register, calculate_model_key(
        name, COLLECTION_MODELS["dense-det"], dataset("rewrite-b"))))
    if status != 200:
        raise AssertionError(f"collection rewrite: the last answer was {status}: {body}")
    check_arrays(response_arrays(body, built.tags_), built.anomaly(X), f"collection {name} after the rewrites")
    return {"requests_and_reloads": len(statuses), "reloads": len(reloads) + 1,
            "reloads_that_caught_a_rewrite": sum(name in c.get("failed", {}) for c in reloads),
            "reloads_that_updated": sum(name in c.get("updated", []) for c in reloads + [last["changes"]])}


def collection_phase(card: str):
    """Build two detectors and two models the bank cannot hold on the card,
    serve them from one directory (bank on), drive every collection route,
    reload under load, then serve them with the bank off."""
    shutil.rmtree(COLLECTION_DIR, ignore_errors=True)
    out_dir = os.path.join(COLLECTION_DIR, "models")
    walls, counts = {}, {}
    t0 = time.perf_counter()
    for name, config in COLLECTION_MODELS.items():
        provide_saved_model(name, config, dataset(name), output_dir=os.path.join(out_dir, name))
    walls["build_s"] = time.perf_counter() - t0
    data = {name: get_dataset(dataset(name)).get_data()[0].values[:COLLECTION_ROWS].astype(np.float32)
            for name in COLLECTION_MODELS}
    own = {name: serializer.load(os.path.join(out_dir, name)) for name in COLLECTION_MODELS}
    detectors = [n for n in COLLECTION_MODELS if n.endswith("-det")]
    banded = {"dense-det": {}, "lstm-det": {"rtol": LSTM_RTOL, "atol": LSTM_ATOL}}
    server = None
    try:
        t0 = time.perf_counter()
        server, base = serve_collection(out_dir, use_bank=True)
        walls["serve_s"] = time.perf_counter() - t0
        status, body = http_json(base + "/models")
        if (status != 200 or body["bank"]["banked"] != sorted(detectors)
                or body["bank"]["fallback"] != COLLECTION_FALLBACK
                or body["accepts"] != ["application/json", TENSOR_CONTENT_TYPE, "application/x-parquet"]):
            raise AssertionError(f"collection /models answered {status}: {body}")
        served = {}
        worst = {}
        before = launches()
        for name in COLLECTION_MODELS:
            X = data[name]
            status, body = http_json(f"{base}/{name}/prediction", {"X": X.tolist()})
            if status != 200:
                raise AssertionError(f"collection: {name} prediction answered {status}: {body}")
            got, want = np.asarray(body["data"], np.float32), np.asarray(own[name].predict(X), np.float32)
            band = banded.get(name, {"rtol": 0.0, "atol": 0.0})  # bare models: the same computation
            check_arrays({"prediction": got}, {"prediction": want}, f"collection {name} prediction", **band)
            worst[name] = float(np.abs(got - want).max())
        counts["predictions"] = launched(before)
        before = launches()
        for name in COLLECTION_MODELS:
            k2 = score.launch_counts["banked_anomaly_score"]
            status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": data[name].tolist()})
            if name in detectors:
                if status != 200 or score.launch_counts["banked_anomaly_score"] <= k2:
                    raise AssertionError(f"collection: {name} anomaly answered {status} without K2: {body}")
                served[name] = body
                check_arrays(response_arrays(body, own[name].tags_), own[name].anomaly(data[name]),
                             f"collection {name} anomaly vs anomaly()", **banded[name])
            elif status != 422 or body != {"error": "Model does not support anomaly scoring"}:
                raise AssertionError(f"collection: {name} anomaly answered {status}, not 422: {body}")
        counts["anomaly_banked"] = launched(before)
        status, health = http_json(server.url + "/healthz")
        ready = http_json(base + "/ready")
        status_md, md = http_json(base + "/metadata-all?digest=1")
        if (status, health["status"]) != (200, "ok") or ready != (200, {"ready": True, "models": 4}):
            raise AssertionError(f"collection /healthz {status} {health}, /ready {ready}")
        if status_md != 200 or {n: t["digest"]["name"] for n, t in md["targets"].items()} != {
                n: n for n in COLLECTION_MODELS}:
            raise AssertionError(f"collection metadata-all?digest=1 answered {status_md}: {md}")
        for name in COLLECTION_MODELS:
            back = serializer.loads(get_bytes(f"{base}/{name}/download-model"))
            model, _ = server.app.collection.entry(name)
            if type(back) is not type(model) or not np.array_equal(back.predict(data[name]),
                                                                   model.predict(data[name])):
                raise AssertionError(f"collection: {name}'s download-model does not predict as the served one")

        # reload under load: one thread POSTs without pause to the targets
        # that stay while a new detector is written, one bare model removed
        statuses, stop = [], threading.Event()
        stay = {"dense-det": "anomaly/prediction", "lstm-det": "anomaly/prediction", "bare-pipe": "prediction"}

        def load():
            while not stop.is_set():
                for name, route in stay.items():
                    statuses.append(http_json(f"{base}/{name}/{route}", {"X": data[name].tolist()})[0])

        loader = threading.Thread(target=load)
        t0 = time.perf_counter()
        before = launches()
        loader.start()
        try:
            provide_saved_model("dense-det-2", COLLECTION_MODELS["dense-det"], dataset("dense-det-2"),
                                output_dir=os.path.join(out_dir, "dense-det-2"))
            reloads = [http_json(base + "/reload", {})]
            shutil.rmtree(os.path.join(out_dir, "bare-ae"))
            reloads.append(http_json(base + "/reload", {}))
            time.sleep(0.5)
        finally:
            stop.set()
            loader.join()
        walls["reload_s"] = time.perf_counter() - t0
        (s1, r1), (s2, r2) = reloads
        if (s1, s2) != (200, 200) or r1["changes"]["added"] != ["dense-det-2"] \
                or r2["changes"]["removed"] != ["bare-ae"] or r2["swap"]["generation"] != 2 \
                or r2["bank_models"] != 3:
            raise AssertionError(f"collection reloads answered {reloads}")
        if not statuses or set(statuses) != {200}:
            raise AssertionError(f"collection: {len(statuses)} requests under reload answered {sorted(set(statuses))}")
        X2 = get_dataset(dataset("dense-det-2")).get_data()[0].values[:COLLECTION_ROWS].astype(np.float32)
        k2 = score.launch_counts["banked_anomaly_score"]
        status, body = http_json(f"{base}/dense-det-2/anomaly/prediction", {"X": X2.tolist()})
        if status != 200 or score.launch_counts["banked_anomaly_score"] <= k2:
            raise AssertionError(f"collection: the new target answered {status} without K2: {body}")
        new = serializer.load(os.path.join(out_dir, "dense-det-2"))
        check_arrays(response_arrays(body, new.tags_), new.anomaly(X2), "collection dense-det-2 after reload")
        counts["reload"] = launched(before)
        pause_ms = [r["swap"]["pause_ms"] for _, r in reloads]
        before = launches()
        rewrite = rewrite_under_reload(base, out_dir, "dense-det-2", X2)
        counts["rewrite"] = launched(before)
        server.close()
        server = None

        # the bank off: every model on the per-model path
        os.environ["GORDO_SERVER_BANK"] = "0"
        try:
            server, base = serve_collection(out_dir, use_bank=None)
        finally:
            del os.environ["GORDO_SERVER_BANK"]
        if server.app.bank is not None or "bank" in http_json(base + "/models")[1]:
            raise AssertionError("collection: GORDO_SERVER_BANK=0 served a bank")
        before = launches()
        per_post = {}
        for name in detectors:
            k = launches()
            status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": data[name].tolist()})
            per_post[name] = launched(k)
            if status != 200 or per_post[name]["K1"] < 1 or per_post[name]["K2"]:
                raise AssertionError(f"collection bank off: {name} answered {status}, launches {per_post[name]}")
            want = response_arrays(served[name], own[name].tags_)
            check_arrays(response_arrays(body, own[name].tags_), want, f"collection {name} per-model vs bank",
                         rtol=1e-4, atol=1e-5)
        k = launches()
        status, body = http_json(f"{base}/bare-pipe/prediction", {"X": data["bare-pipe"].tolist()})
        per_post["bare-pipe"] = launched(k)
        if status != 200 or per_post["bare-pipe"]["K3"] < 1:
            raise AssertionError(f"collection bank off: bare-pipe answered {status}, launches {per_post['bare-pipe']}")
        counts["bank_off"] = launched(before)
    finally:
        if server is not None:
            server.close()
        shutil.rmtree(COLLECTION_DIR, ignore_errors=True)
    phase("collection", models=json.dumps(sorted(COLLECTION_MODELS)), rows=COLLECTION_ROWS, tags=10,
          lookback=COLLECTION_LOOKBACK, epochs=COLLECTION_EPOCHS,
          banked=json.dumps(sorted(detectors)), fallback=json.dumps(COLLECTION_FALLBACK),
          prediction_max_err=json.dumps(worst), requests_under_reload=len(statuses),
          non_200_under_reload=sum(s != 200 for s in statuses), generation=2,
          pause_ms=json.dumps(pause_ms), rewrite_under_reload=json.dumps(rewrite),
          bank_off_launches_per_post=json.dumps(per_post),
          launches=json.dumps(counts), walls_s=json.dumps({k: round(v, 3) for k, v in walls.items()}),
          card=json.dumps(card))


# ------------------------------------------------------------------ #
# phase: real data, from the in-repo lake and from an InfluxDB stub
# ------------------------------------------------------------------ #

LAKE_DIR = os.path.join(ROOT, "build", "chip_smoke_lake")
LAKE_STORE = os.path.join(ROOT, "examples", "datalake")
LAKE_ROW_FILTER = "`GRA-T1` > -0.5 & `IROC-B` < 1.5"
LAKE_LSTM_MODEL = detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=LOOKBACK, epochs=5)
# lake-parquet's rows of 2021 in get_data(), as the JAX package gives them on
# the CPU (tests/test_torch_parquet.py holds both packages to this number)
LAKE_PARQUET_2021_ROWS = 400
# the JAX client's parquet bodies of lake-parquet's first 48 rows of 2021
# (tools/make_parquet_fixtures.py); the second carries ``__y__`` targets
PARQUET_BODIES = [os.path.join(ROOT, "examples", "parquet", f) for f in ("post_body.parquet", "post_body_y.parquet")]


def lake_machines(influx_port: int) -> list:
    """The lake phase's fleet: the README's lake machine, an LSTM machine
    over every 2020 tag of the lake with a row filter, an InfluxDB machine
    over the stub at ``influx_port``, and a machine whose range reaches
    into the lake's 2021 parquet files."""
    lake = {"type": "DataLakeProvider", "store_path": LAKE_STORE}
    return [
        {"name": "lake-dense",
         "dataset": {"type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
                     "train_end_date": "2020-01-10T00:00:00Z",
                     "tag_list": [["GRA-T1", "asset-a"], ["IROC-A", "asset-b"]], "data_provider": lake},
         "model": {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {}}},
        {"name": "lake-lstm",
         "dataset": {"type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
                     "train_end_date": "2020-01-17T00:00:00Z",
                     "tag_list": [["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["GRA-P1", "asset-a"],
                                  ["IROC-A", "asset-b"], ["IROC-B", "asset-b"]],
                     "row_filter": LAKE_ROW_FILTER, "data_provider": lake},
         "model": LAKE_LSTM_MODEL},
        {"name": "influx-machine",
         "dataset": {"type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
                     "train_end_date": "2020-01-10T00:00:00Z", "tag_list": ["GRA-T1", "GRA-T2"],
                     "data_provider": {"type": "InfluxDataProvider", "measurement": "sensors",
                                       "value_name": "Value", "uri": f"http://127.0.0.1:{influx_port}/db"}}},
        {"name": "lake-parquet",
         "dataset": {"type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
                     "train_end_date": "2021-01-18T00:00:00Z",
                     "tag_list": [["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["GRA-P1", "asset-a"]],
                     "data_provider": lake},
         "model": {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {}}},
    ]


def parquet_posts(base: str, rows) -> dict:
    """POST each of PARQUET_BODIES to lake-parquet as parquet and as JSON of
    the same rows: the two answers must be equal. The bodies' rows must be
    lake-parquet's first 48 of 2021. Returns what was posted."""
    first_2021 = rows.values[rows.index >= np.datetime64("2021-01-01")]
    posted = {}
    for path in PARQUET_BODIES:
        with open(path, "rb") as f:
            raw = f.read()
        index, names, columns = read_parquet_bytes(raw, path)
        x_names = [n for n in names if not n.startswith("__y__")]
        y_names = [n for n in names if n.startswith("__y__")]
        X = np.stack([columns[n] for n in x_names], axis=1)
        if x_names != list(rows.columns) or not np.array_equal(X.astype(np.float32), first_2021[:len(X)]):
            raise AssertionError(f"{path}: its rows are not lake-parquet's first {len(X)} of 2021")
        body = {"X": X.tolist(), "index": [isoformat(t) for t in index]}
        if y_names:
            body["y"] = np.stack([columns[n] for n in y_names], axis=1).tolist()
        for route in ("anomaly/prediction", "prediction"):
            url = f"{base}/lake-parquet/{route}"
            status, by_parquet = http_json(url, raw=raw, content_type="application/x-parquet")
            if status != 200:
                raise AssertionError(f"lake-parquet: the parquet body {path} answered {status}: {by_parquet}")
            if http_json(url, body) != (status, by_parquet):
                raise AssertionError(f"lake-parquet {route}: {path} answered otherwise as parquet than as JSON")
        posted[os.path.basename(path)] = {"rows": len(X), "bytes": len(raw), "y": bool(y_names)}
    return posted


class InfluxStub:
    """A loopback HTTP server answering the InfluxDB 1.x ``/query``
    dialect for ``tags`` of the lake's asset-a, read from their 2020 CSV
    files with the standard library: the values as written, the times as
    RFC3339 with nanoseconds. It parses the tag literal and the time range
    out of each query."""

    QUERY = re.compile(r"FROM \"([^\"]*)\" WHERE \(\"tag\" = '((?:\\.|[^'\\])*)'\) "
                       r"AND time >= '([^']*)' AND time < '([^']*)'")

    def __init__(self, tags):
        rows = {}
        for tag in tags:
            with open(os.path.join(LAKE_STORE, "asset-a", tag, f"{tag}_2020.csv")) as f:
                rows[tag] = [(datetime.datetime.fromisoformat(t.strip()), float(v))
                             for _, v, t in (line.split(";") for line in f if line.strip())]
        self.queries = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query).get("q", [""])[0]
                outer.queries.append(q)
                m = outer.QUERY.search(q)
                result = {"statement_id": 0}
                if m:
                    tag = re.sub(r"\\(.)", r"\1", m.group(2))
                    lo, hi = (datetime.datetime.fromisoformat(t) for t in m.group(3, 4))
                    values = [[t.strftime("%Y-%m-%dT%H:%M:%S.%f") + "000Z", v]
                              for t, v in rows.get(tag, []) if lo <= t < hi]
                    if values:
                        result["series"] = [{"name": m.group(1), "columns": ["time", "Value"],
                                             "values": values}]
                payload = json.dumps({"results": [result]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def lake_phase(card: str):
    """Build and serve the lake phase's four machines through the CLI in
    subprocesses; one anomaly POST a machine held against ``anomaly()``
    here, and lake-parquet's parquet and JSON POSTs held equal. Returns the
    CLI runs' launch counts, summed."""
    shutil.rmtree(LAKE_DIR, ignore_errors=True)
    os.makedirs(LAKE_DIR)
    out_dir = os.path.join(LAKE_DIR, "models")
    stub = InfluxStub(["GRA-T1", "GRA-T2"])
    runs, loaded, server = {}, {}, None
    try:
        machines = lake_machines(stub.port)
        fleet_file = os.path.join(LAKE_DIR, "fleet.json")
        with open(fleet_file, "w") as f:
            json.dump({"machines": machines}, f, indent=2)
        t0 = time.perf_counter()
        proc = cli("lake_build_fleet", ["build-fleet", "--machines-file", fleet_file, "--output-dir", out_dir],
                   counts_dir=LAKE_DIR)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"lake build-fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
        manifest = json.loads(proc.stdout)
        names = sorted(m["name"] for m in machines)
        if sorted(manifest["built"]) != names or manifest["failed"]:
            raise AssertionError(f"lake build-fleet: {manifest}")
        runs["build_fleet"] = cli_counts("lake_build_fleet", counts_dir=LAKE_DIR)
        build_queries = len(stub.queries)

        data = {}
        for machine in machines:
            t = time.perf_counter()
            ds = get_dataset(machine["dataset"])
            data[machine["name"]] = ds.get_data()[0]
            md = ds.get_metadata()
            built = serializer.load_metadata(os.path.join(out_dir, machine["name"]))["dataset"]
            loaded[machine["name"]] = {
                "rows": data[machine["name"]].values.shape[0], "load_s": round(time.perf_counter() - t, 4),
                "build_rows": built["rows_after_filter"], "rows_joined": md["rows_joined"],
                "rows_after_dropna": md["rows_after_dropna"], "rows_after_filter": md["rows_after_filter"],
                "tag_loading": md["tag_loading"]}
            if built["rows_after_filter"] != md["rows_after_filter"] or built["tag_loading"] != md["tag_loading"]:
                raise AssertionError(f"lake {machine['name']}: the build loaded {built}, here {md}")
        rows_2021 = int((data["lake-parquet"].index >= np.datetime64("2021-01-01")).sum())
        if rows_2021 != LAKE_PARQUET_2021_ROWS:
            raise AssertionError(f"lake-parquet: {rows_2021} rows of 2021, the JAX package's get_data() "
                                 f"{LAKE_PARQUET_2021_ROWS}")
        lstm = loaded["lake-lstm"]
        if not 0 < lstm["rows_after_filter"] < lstm["rows_after_dropna"]:
            raise AssertionError(f"lake-lstm: the row filter kept {lstm['rows_after_filter']} of "
                                 f"{lstm['rows_after_dropna']} rows")
        # the InfluxDB machine's rows are the lake's, over the wire
        same = get_dataset(dict(machines[2]["dataset"], tag_list=[["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"]],
                                data_provider={"type": "DataLakeProvider", "store_path": LAKE_STORE}))
        if not np.array_equal(same.get_data()[0].values, data["influx-machine"].values):
            raise AssertionError("influx-machine: its rows over the wire are not the lake's")

        port = free_port()
        log = open(os.path.join(LAKE_DIR, "server.log"), "w")
        t1 = time.perf_counter()
        server = subprocess.Popen(
            cli_command("lake_run_server", ["run-server", "--model-dir", out_dir, "--host", "127.0.0.1",
                                            "--port", str(port)], counts_dir=LAKE_DIR),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            base = f"http://127.0.0.1:{port}/gordo/v0/smoke"
            status, models = wait_for_models(base, server, t1)
            serve_s = time.perf_counter() - t1
            if status != 200 or models["models"] != names:
                raise AssertionError(f"lake run-server /models answered {status}: {models}")
            for machine in machines:
                name, X = machine["name"], data[machine["name"]]
                status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": X.values.tolist()})
                if status != 200:
                    raise AssertionError(f"lake run-server: {name} answered {status}: {body}")
                want = serializer.load(os.path.join(out_dir, name)).anomaly(X.values)
                band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if name == "lake-lstm" else {}
                check_arrays(response_arrays(body, X.columns), want, f"lake {name}", **band)
            posted = parquet_posts(base, data["lake-parquet"])
        finally:
            stop_server(server)
            log.close()
        if server.returncode != 0:
            raise AssertionError(f"lake run-server exited {server.returncode} on SIGTERM")
        runs["run_server"] = cli_counts("lake_run_server", counts_dir=LAKE_DIR)
    finally:
        stub.close()
        shutil.rmtree(LAKE_DIR, ignore_errors=True)
    if runs["build_fleet"]["lstm_layer"] <= 0 or runs["run_server"]["lstm_layer"] <= 0 \
            or runs["run_server"]["banked_anomaly_score"] < len(machines):
        raise AssertionError(f"lake: K3 in the build and server runs, K2 for every POST: {runs}")
    phase("lake", built=json.dumps(names), build_fleet_s=round(build_s, 3), server_ready_s=round(serve_s, 3),
          influx_queries_in_build=build_queries, posts=len(machines), checked="all six arrays vs anomaly() here",
          pyarrow="blocked in every CLI run", rows_2021=rows_2021,
          parquet_posts=json.dumps(posted), parquet_vs_json="equal",
          row_filter=json.dumps(LAKE_ROW_FILTER), datasets=json.dumps(loaded),
          launches_by_run=json.dumps(runs), card=json.dumps(card))
    return {k: sum(c[k] for c in runs.values()) for k in runs["build_fleet"]}


# ------------------------------------------------------------------ #
# phase: every preprocessing definition the JAX package builds, through
# the CLI at config 1's width
# ------------------------------------------------------------------ #

DEFINITIONS_DIR = os.path.join(ROOT, "build", "chip_smoke_definitions")
_HOURGLASS = {"gordo_components_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass"}}
DEFINITION_STEPS = {  # machine -> its named preprocessing step, and whether the bank holds it
    "def-robust": (["robust", "sklearn.preprocessing.RobustScaler"], True),
    "def-robust-uncentered": (["robust", {"sklearn.preprocessing.RobustScaler": {"with_centering": False}}], True),
    "def-maxabs": (["maxabs", "sklearn.preprocessing.MaxAbsScaler"], True),
    "def-standard-unscaled": (["standard", {"sklearn.preprocessing.StandardScaler": {"with_std": False}}], True),
    "def-pca": (["pca", {"sklearn.decomposition.PCA": {"n_components": 3}}], False),
    "def-union": (["union", {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
        ["minmax", "sklearn.preprocessing.MinMaxScaler"],
        ["pca", {"sklearn.decomposition.PCA": {"n_components": 2}}]]}}], False),
    "def-business-days": (["minmax", "sklearn.preprocessing.MinMaxScaler"], True),
}
DEFINITION_TTR = "def-ttr"
# a calendar resolution: a year of business days (weekend rows fold into the Friday before)
DEFINITION_CALENDAR = {"def-business-days": {"resolution": "B", "train_start_date": "2020-01-01T00:00:00Z",
                                             "train_end_date": "2021-01-01T00:00:00Z"}}


def definition_machines() -> list:
    """The definitions phase's fleet: a detector over each step of
    DEFINITION_STEPS and a bare TransformedTargetRegressor (its target the
    tags themselves), each on its own week of 10 tags; DEFINITION_CALENDAR's
    machine on a year resampled at a calendar resolution."""
    machines = [{"name": name, "dataset": dict(dataset(name), **DEFINITION_CALENDAR.get(name, {})), "model": {
        "gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "sklearn.pipeline.Pipeline": {"steps": [step, ["model", _HOURGLASS]]}}}}}
        for name, (step, _) in DEFINITION_STEPS.items()]
    data = dataset(DEFINITION_TTR)
    machines.append({"name": DEFINITION_TTR, "dataset": dict(data, target_tag_list=data["tag_list"]), "model": {
        "sklearn.compose.TransformedTargetRegressor": {
            "regressor": _HOURGLASS, "transformer": "sklearn.preprocessing.MinMaxScaler"}}})
    return machines


def definitions_phase(card: str):
    """Build DEFINITION_STEPS' detectors and the transformed-target
    regressor with ``build-fleet`` and serve them with ``run-server``, CLI
    subprocesses on the card; each POST's answer against the same
    artifact's answer on the CPU here. Returns the CLI runs' launch counts,
    summed."""
    shutil.rmtree(DEFINITIONS_DIR, ignore_errors=True)
    os.makedirs(DEFINITIONS_DIR)
    out_dir = os.path.join(DEFINITIONS_DIR, "models")
    machines = definition_machines()
    names = sorted(m["name"] for m in machines)
    fleet_file = os.path.join(DEFINITIONS_DIR, "fleet.json")
    with open(fleet_file, "w") as f:
        json.dump({"machines": machines}, f, indent=2)
    runs, server = {}, None
    try:
        t0 = time.perf_counter()
        proc = cli("definitions_build_fleet", ["build-fleet", "--machines-file", fleet_file, "--output-dir", out_dir],
                   counts_dir=DEFINITIONS_DIR)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"definitions build-fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
        manifest = json.loads(proc.stdout)
        if sorted(manifest["built"]) != names or manifest["failed"]:
            raise AssertionError(f"definitions build-fleet: {manifest}")
        runs["build_fleet"] = cli_counts("definitions_build_fleet", counts_dir=DEFINITIONS_DIR)

        port = free_port()
        log = open(os.path.join(DEFINITIONS_DIR, "server.log"), "w")
        t1 = time.perf_counter()
        server = subprocess.Popen(
            cli_command("definitions_run_server", ["run-server", "--model-dir", out_dir, "--host", "127.0.0.1",
                                                   "--port", str(port)], counts_dir=DEFINITIONS_DIR),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        )
        checked = {}
        try:
            base = f"http://127.0.0.1:{port}/gordo/v0/smoke"
            status, models = wait_for_models(base, server, t1)
            serve_s = time.perf_counter() - t1
            banked = sorted(n for n, (_, b) in DEFINITION_STEPS.items() if b)
            fallback = models.get("bank", {}).get("fallback", {})
            if status != 200 or models["models"] != names or models["bank"]["banked"] != banked:
                raise AssertionError(f"definitions run-server /models answered {status}: {models}")
            for name in ("def-pca", "def-union"):
                step = DEFINITION_STEPS[name][0][0]
                if fallback.get(name) != f"non-affine preprocessing step {step!r}":
                    raise AssertionError(f"definitions: {name} is not under fallback as non-affine: {fallback}")
            for machine in machines:
                name = machine["name"]
                X = get_dataset(machine["dataset"]).get_data()[0].values
                want_model = serializer.load(os.path.join(out_dir, name), device="cpu")
                if name == DEFINITION_TTR:
                    status, body = http_json(f"{base}/{name}/prediction", {"X": X.tolist()})
                    if status != 200:
                        raise AssertionError(f"definitions: {name} answered {status}: {body}")
                    check_arrays({"prediction": body["data"]}, {"prediction": want_model.predict(X)},
                                 f"definitions {name}")
                    checked[name] = "prediction"
                    continue
                status, body = http_json(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})
                if status != 200:
                    raise AssertionError(f"definitions: {name} answered {status}: {body}")
                want = want_model.anomaly(X)
                check_arrays(response_arrays(body, want_model.tags_, want_model.output_tags), want,
                             f"definitions {name}")
                checked[name] = f"anomaly, {want['model-output'].shape[1]} model-space columns"
        finally:
            stop_server(server)
            log.close()
        if server.returncode != 0:
            raise AssertionError(f"definitions run-server exited {server.returncode} on SIGTERM")
        runs["run_server"] = cli_counts("definitions_run_server", counts_dir=DEFINITIONS_DIR)
    finally:
        shutil.rmtree(DEFINITIONS_DIR, ignore_errors=True)
    served = runs["run_server"]
    n_banked = sum(b for _, b in DEFINITION_STEPS.values())
    if served["banked_anomaly_score"] < n_banked or served["fused_anomaly_score"] < len(DEFINITION_STEPS) - n_banked:
        raise AssertionError(f"definitions: K2 for every banked POST, K1 in each per-model anomaly(): {runs}")
    phase("definitions", built=json.dumps(names), build_fleet_s=round(build_s, 3), server_ready_s=round(serve_s, 3),
          banked=json.dumps(banked), fallback=json.dumps(fallback), checked=json.dumps(checked),
          band=f"rtol=0,atol={E2E_ATOL} vs the CPU", launches_by_run=json.dumps(runs), card=json.dumps(card))
    return {k: sum(c[k] for c in runs.values()) for k in runs["build_fleet"]}


OBSERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_observe")
# 64 rows of 10 tags, the JAX client's parquet encoding (tools/make_parquet_fixtures.py)
OBSERVE_PARQUET = os.path.join(ROOT, "examples", "parquet", "post_body_10tags.parquet")
OBSERVE_SOUND = ("obs-dense", "obs-lstm", "obs-pca")
OBSERVE_POSTS = dict(json=8, parquet=4)  # anomaly POSTs to each sound model
OBSERVE_404S = 3
OBSERVE_MEMBERS = 10_000  # the instrumentation loops' dense bank
OBSERVE_PCA = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        ["pca", {"sklearn.decomposition.PCA": {"n_components": 3}}],
        ["model", {"gordo_components_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": 3}}]]}}}}
DEADLINE_HEADERS = {"X-Gordo-Deadline-Ms": "0.001"}


def post_anomaly(base: str, target: str, X, headers=None):
    """(status, headers, JSON body) of an anomaly POST of ``X``."""
    status, hdrs, raw = http_raw(f"{base}/{target}/anomaly/prediction", json.dumps({"X": X.tolist()}).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    return status, hdrs, json.loads(raw)


def tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(o) for o in obj)
    return 0


def bank_bytes(bank) -> int:
    """The bytes of every tensor the bank's buckets hold on the card."""
    return sum(tensor_bytes(v) for b in bank._buckets.values() for v in vars(b).values())


def scrape(base: str) -> dict:
    """``/metrics`` parsed by the port's parser: (name, sorted labels) -> value."""
    status, hdrs, text = http_raw(base + "/metrics")
    if status != 200 or hdrs["Content-Type"] != "text/plain; version=0.0.4; charset=utf-8":
        raise AssertionError(f"/metrics answered {status} as {hdrs.get('Content-Type')}")
    _, samples = parse_prometheus_text(text.decode())
    return {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}


def totals_finite(body) -> np.ndarray:
    return np.isfinite(np.asarray(body["data"]["total-anomaly-scaled"], np.float64))


def observe_counters(server, base: str, rng) -> dict:
    """8 JSON and 4 parquet anomaly POSTs to each sound model from 12
    threads, and OBSERVE_404S unknown routes; then ``/metrics`` and
    ``/stats`` must give the same integers."""
    with open(OBSERVE_PARQUET, "rb") as f:
        pq = f.read()
    X = rng.random((len(OBSERVE_SOUND), OBSERVE_POSTS["json"], 64, 10)).astype(np.float32)
    jobs = [(t, X[i, j]) for i, t in enumerate(OBSERVE_SOUND) for j in range(OBSERVE_POSTS["json"])]
    jobs += [(t, None) for t in OBSERVE_SOUND for _ in range(OBSERVE_POSTS["parquet"])]
    replies = []

    def post(job):
        t, x = job
        if x is None:
            status, _, raw = http_raw(f"{base}/{t}/anomaly/prediction", pq, {"Content-Type": "application/x-parquet"})
        else:
            status, _, raw = http_raw(f"{base}/{t}/anomaly/prediction", json.dumps({"X": x.tolist()}).encode(),
                                      {"Content-Type": "application/json"})
        replies.append((t, status, json.loads(raw)))

    threads = [threading.Thread(target=lambda chunk=jobs[i::12]: [post(j) for j in chunk]) for i in range(12)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    for t, status, body in replies:
        if status != 200 or not totals_finite(body).all():
            raise AssertionError(f"observe: {t} answered {status} or non-finite totals")
    for _ in range(OBSERVE_404S):
        if http_raw(base + "/nowhere/at/all")[0] != 404:
            raise AssertionError("observe: an unknown route did not answer 404")
    values = scrape(base)
    status, _, raw = http_raw(base + "/stats")
    stats = json.loads(raw)
    if status != 200 or len(replies) != len(jobs):
        raise AssertionError(f"observe: /stats answered {status}; {len(replies)} of {len(jobs)} POSTs answered")

    def metric(name, **labels):
        return values.get((name, tuple(sorted(labels.items()))))

    # /metrics was read just before /stats, whose own request is its first
    requests = {k: n for k, n in stats["requests"].items() if k != "stats"}
    if requests.get("anomaly") != len(jobs) or requests.get("other") != OBSERVE_404S:
        raise AssertionError(f"observe: /stats counts {requests}, not {len(jobs)} anomaly, {OBSERVE_404S} other")
    pairs = {f"requests[{k}]": (n, metric("gordo_server_requests_total", kind=k)) for k, n in requests.items()}
    pairs["errors"] = (stats["errors"], metric("gordo_server_errors_total"))
    engine = stats["bank_engine"]
    pairs["engine.requests"] = (engine["requests"], metric("gordo_engine_requests_total"))
    pairs["engine.batches"] = (engine["batches"], metric("gordo_engine_batches_total"))
    for enc in ("json", "parquet"):
        pairs[f"wire.requests[{enc}]"] = (stats["wire"]["requests"].get(enc),
                                          metric("gordo_server_requests_total", encoding=enc))
        pairs[f"wire.bytes[{enc}]"] = (stats["wire"]["bytes"].get(enc),
                                       metric("gordo_server_request_bytes_total", encoding=enc))
    calls = {v["labels"]["bucket"]: v["value"] for v in stats["metrics"]["gordo_bank_bucket_calls_total"]["values"]}
    for bucket, n in calls.items():
        pairs[f"bucket_calls[{bucket}]"] = (n, metric("gordo_bank_bucket_calls_total", bucket=bucket))
    apart = {k: v for k, v in pairs.items() if v[0] is None or v[0] != v[1]}
    if apart or len(calls) != 2 or stats["errors"] != OBSERVE_404S:
        raise AssertionError(f"observe: /stats and /metrics disagree: {apart}; bucket calls {calls}")
    wire = {enc: stats["wire"]["requests"][enc] for enc in ("json", "parquet")}
    if wire != {enc: n * len(OBSERVE_SOUND) for enc, n in OBSERVE_POSTS.items()}:
        raise AssertionError(f"observe: wire {wire}")
    device = f"cuda:{torch.cuda.current_device()}"
    hbm = {k: metric(f"gordo_device_hbm_{k}", device=device) for k in ("bytes_in_use", "bytes_limit",
                                                                        "peak_bytes_in_use")}
    weights = bank_bytes(server.app.bank)
    if None in hbm.values() or not weights <= hbm["bytes_in_use"] <= hbm["bytes_limit"]:
        raise AssertionError(f"observe: HBM gauges {hbm} against the bank's {weights} bytes")
    return {"posts": len(jobs), "counters_equal": len(pairs), "requests": json.dumps(requests),
            "engine_requests": engine["requests"], "engine_batches": engine["batches"],
            "bucket_calls": json.dumps(calls), "wire": json.dumps(stats["wire"]),
            "hbm": json.dumps(hbm), "bank_tensor_bytes": weights}


def observe_quarantine(server, base: str, dense, rng) -> dict:
    """The poisoned member's three NaN answers (at once with the sound
    members' POSTs), the 410 that launches nothing, /healthz and the gauge,
    a batch that holds it beside sound members, clear, and a rewrite with
    sound weights that /reload re-admits."""
    probe = rng.random((64, 10)).astype(np.float32)
    alone = {t: post_anomaly(base, t, probe) for t in ("obs-dense", "obs-lstm")}
    targets = ["obs-nan"] * 3 + ["obs-dense", "obs-lstm"]
    replies, barrier = {}, threading.Barrier(len(targets))

    def post(i, t):
        barrier.wait(60)
        replies[i] = post_anomaly(base, t, probe)

    threads = [threading.Thread(target=post, args=(i, t)) for i, t in enumerate(targets)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    for i, t in enumerate(targets):
        status, _, body = replies[i]
        if status != 200:
            raise AssertionError(f"observe: {t} answered {status} before the quarantine: {body}")
        if t == "obs-nan" and totals_finite(body).any():
            raise AssertionError("observe: the poisoned member answered a finite total")
        if t != "obs-nan":
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if t == "obs-lstm" else {}
            tags = [f"tag-{j}" for j in range(10)]
            check_arrays(response_arrays(body, tags), response_arrays(alone[t][2], tags),
                         f"observe {t} beside the poisoned member", **band)
    # one batch with the poisoned member in two slots against the same batch
    # with a sound member there: the neighbours' results bitwise
    bank = server.app.bank
    batch = [("obs-nan", probe, None), ("obs-dense", probe, None), ("obs-nan", probe[:40], None),
             ("obs-lstm", probe, None)]
    mixed = bank.score_many(batch)
    twin = bank.score_many([("obs-dense", x, y) if n == "obs-nan" else (n, x, y) for n, x, y in batch])
    for i in (1, 3):
        for key, want in twin[i].to_arrays().items():
            if not np.array_equal(mixed[i].to_arrays()[key], want):
                raise AssertionError(f"observe: {batch[i][0]}'s {key} moved beside the poisoned member")
    if np.isfinite(mixed[0].total_scaled).any() or np.isfinite(mixed[2].total_scaled).any():
        raise AssertionError("observe: the poisoned member's batched totals are finite")
    before = launches()
    status, _, gone = post_anomaly(base, "obs-nan", probe)
    moved = launched(before)
    if status != 410 or gone.get("reason") != "non-finite scores in model output" or gone.get("failures") != 3:
        raise AssertionError(f"observe: the fourth POST answered {status}: {gone}")
    if any(moved.values()):
        raise AssertionError(f"observe: the 410 launched {moved}")
    status, _, raw = http_raw(base.replace("/gordo/v0/smoke", "") + "/healthz")
    health = json.loads(raw)
    if status != 200 or health["status"] != "degraded" or list(health["quarantined"]) != ["obs-nan"]:
        raise AssertionError(f"observe: /healthz answered {status}: {health}")
    gauge = scrape(base)[("gordo_quarantined_models", ())]
    if gauge != 1:
        raise AssertionError(f"observe: gordo_quarantined_models is {gauge}")
    for t in ("obs-dense", "obs-lstm", "obs-pca"):
        status, _, body = post_anomaly(base, t, probe)
        if status != 200 or not totals_finite(body).all():
            raise AssertionError(f"observe: {t} answered {status} while obs-nan was quarantined")
    clear = json.dumps({"targets": ["obs-nan"]}).encode()
    status, _, raw = http_raw(base + "/quarantine/clear", clear, {"Content-Type": "application/json"})
    if status != 200 or json.loads(raw) != {"enabled": True, "cleared": ["obs-nan"]}:
        raise AssertionError(f"observe: quarantine/clear answered {status}: {raw[:200]}")
    # re-admitted: three more NaN answers quarantine it again
    statuses = [post_anomaly(base, "obs-nan", probe)[0] for _ in range(4)]
    if statuses != [200, 200, 200, 410]:
        raise AssertionError(f"observe: after clear the poisoned member answered {statuses}")
    serializer.dump(dataclasses.replace(dense, name="obs-nan"), os.path.join(OBSERVE_DIR, "obs-nan"))
    status, _, raw = http_raw(base + "/reload", b"{}", {"Content-Type": "application/json"})
    reload = json.loads(raw)
    if status != 200 or reload["changes"]["updated"] != ["obs-nan"]:
        raise AssertionError(f"observe: /reload answered {status}: {reload}")
    status, _, raw = http_raw(base + "/quarantine")
    if json.loads(raw)["quarantined"]:
        raise AssertionError(f"observe: /reload left the verdict: {raw[:300]}")
    status, _, body = post_anomaly(base, "obs-nan", probe)
    if status != 200 or not totals_finite(body).all():
        raise AssertionError(f"observe: the rewritten member answered {status} or non-finite totals")
    check_arrays(response_arrays(body, dense.tags), response_arrays(alone["obs-dense"][2], dense.tags),
                 "observe: the rewritten member against obs-dense")
    return {"quarantined_after": 3, "gone_launches": json.dumps(moved), "healthz": health["status"],
            "after_clear": json.dumps(statuses), "reload_generation": reload["swap"]["generation"]}


def observe_deadlines(server, base: str, rng) -> dict:
    """A POST whose deadline has passed answers 504 on the bank path and on
    the per-model path, echoes the request id, launches nothing, counts in
    the engine's deadline_expired and not in the breaker."""
    X = rng.random((64, 10)).astype(np.float32)
    engine, quarantine = server.app.engine, server.app.quarantine
    expired = engine.stats_snapshot()["deadline_expired"]
    breaker = quarantine.snapshot()
    before = launches()
    sent = {"obs-dense": "obs-504-bank", "obs-pca": "obs-504-per-model"}
    for t, rid in sent.items():
        status, hdrs, body = post_anomaly(base, t, X, {**DEADLINE_HEADERS, "X-Gordo-Request-Id": rid})
        if (status != 504 or body.get("request_id") != rid or hdrs.get("X-Gordo-Request-Id") != rid
                or "Retry-After" in hdrs):
            raise AssertionError(f"observe: the expired POST to {t} answered {status} {hdrs}: {body}")
    moved = launched(before)
    counted = engine.stats_snapshot()["deadline_expired"] - expired
    if any(moved.values()) or counted != len(sent) or quarantine.snapshot() != breaker:
        raise AssertionError(f"observe: the 504s launched {moved}, counted {counted}, breaker "
                             f"{quarantine.snapshot()}")
    return {"deadline_504s": len(sent), "deadline_launches": json.dumps(moved), "deadline_expired": counted}


class _AfterFirstGroup(Deadline):
    """A deadline that passes once the first bucket group has dispatched:
    the bank's check between groups, without a race against the clock."""

    checks = 0

    def expired(self, now=None) -> bool:
        self.checks += 1
        return self.checks > 1


def observe_held_deadlines(server, rng) -> dict:
    """The deadline checks behind admission, on the card, over a bank of
    the served dense and LSTM members built with ``registry=False`` (the
    app's series stay the server's): a request whose 20 ms budget runs out
    while a 200 ms flush holds its batch is dropped before dispatch and
    launches nothing; a batch deadline that passes after the dense group
    leaves the LSTM group undispatched (no K3 launch) and the dense result
    bitwise its answer alone."""
    models = server.app.collection.models
    bank = ModelBank.from_models({n: models[n] for n in ("obs-dense", "obs-lstm")}, registry=False)
    X = rng.random((64, 10)).astype(np.float32)
    alone = bank.score_many([("obs-dense", X, None)])[0]
    engine = BatchingEngine(bank, max_batch=64, flush_ms=200.0)
    engine.start()
    try:
        before = launches()
        try:
            engine.submit("obs-dense", X, deadline=Deadline.after_ms(20.0)).result(timeout=30)
            raise AssertionError("observe: a request held past its deadline was scored")
        except DeadlineExceeded:
            pass
        held = launched(before)
        if any(held.values()) or engine.stats_snapshot()["deadline_expired"] != 1:
            raise AssertionError(f"observe: the held request launched {held}, engine {engine.stats_snapshot()}")
    finally:
        engine.stop()
    before = launches()
    got = bank.score_many([("obs-dense", X, None), ("obs-lstm", X, None)], deadline=_AfterFirstGroup(60.0),
                          return_exceptions=True)
    cut = launched(before)
    if not isinstance(got[1], DeadlineExceeded) or cut["K3"] != 0 or cut["K2"] < 1:
        raise AssertionError(f"observe: the cut batch gave {type(got[1]).__name__}, launched {cut}")
    for key, want in alone.to_arrays().items():
        if not np.array_equal(got[0].to_arrays()[key], want):
            raise AssertionError(f"observe: the dense group's {key} moved when the LSTM group was cut")
    return {"held_drop_launches": json.dumps(held), "cut_batch_launches": json.dumps(cut)}


def observe_gzip(base: str) -> dict:
    plain = http_raw(base + "/metadata-all?digest=1")
    packed = http_raw(base + "/metadata-all?digest=1", headers={"Accept-Encoding": "gzip"})
    if (plain[0], packed[0]) != (200, 200) or packed[1].get("Content-Encoding") != "gzip" \
            or json.loads(gzip.decompress(packed[2])) != json.loads(plain[2]):
        raise AssertionError(f"observe: the gzipped digest ({packed[0]}, {packed[1]}) is not the plain body")
    return {"digest_bytes": len(plain[2]), "digest_gzip_bytes": len(packed[2])}


OBSERVE_COST_ROUNDS = 3  # rounds of (with, without, without, with); cut from 5


def instrumentation_cost(rng) -> dict:
    """The bank phase's closed loop (64 clients x 4 requests of 64 rows to
    random members of a dense bank of OBSERVE_MEMBERS) through an engine and
    bank that record into a registry, and through ones built with
    ``registry=False``: one untimed loop on each, then OBSERVE_COST_ROUNDS
    rounds in the order with, without, without, with. The median of each
    side's p50, p99 and rows/s, and every run's; findings, not a claim."""
    n_clients, n_requests, n_rows = 64, 4, 64
    entries = [random_entry(f"i{i:05d}", 10, rng) for i in range(OBSERVE_MEMBERS)]
    X = rng.random((n_clients, n_requests, n_rows, 10)).astype(np.float32)
    names = [[entries[int(j)].name for j in rng.integers(0, OBSERVE_MEMBERS, n_requests)]
             for _ in range(n_clients)]
    registry = MetricsRegistry()
    banks = {"instrumented": ModelBank.from_entries(entries, registry=registry),
             "uninstrumented": ModelBank.from_entries(entries, registry=False)}
    del entries
    gc.collect()
    order = ["instrumented", "uninstrumented"] + ["instrumented", "uninstrumented", "uninstrumented",
                                                  "instrumented"] * OBSERVE_COST_ROUNDS
    runs = {label: [] for label in banks}
    for i, label in enumerate(order):
        engine = BatchingEngine(banks[label], max_batch=64, flush_ms=2.0)
        if (engine.registry is registry) != (label == "instrumented"):
            raise AssertionError(f"observe: the {label} engine's registry is {engine.registry}")
        engine.start()
        try:
            engine.score_blocking(names[0][0], X[0, 0])
            lat, results, wall = closed_loop(engine, names, X, f"observe {label} loop")
        finally:
            engine.stop()
        if not all(np.isfinite(r.total_scaled).all() for r in results.values()):
            raise AssertionError(f"observe: the {label} loop scored non-finite totals")
        if i < len(banks):
            continue  # the untimed first loop of each
        lat_ms = np.asarray(lat) * 1e3
        runs[label].append({
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 4),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
            "rows_per_s": round(len(results) * n_rows / wall, 1),
        })
    # the registry renders the last instrumented engine's counters (a new
    # engine replaces its collector) and every instrumented engine's histograms
    counted = {(n, tuple(lb.items())): v for n, lb, v in parse_prometheus_text(registry.render())[1]}
    per_loop = 1 + n_clients * n_requests
    want = {"gordo_engine_requests_total": per_loop,
            "gordo_engine_queue_wait_seconds_count": per_loop * order.count("instrumented")}
    if any(counted[(k, ())] != v for k, v in want.items()):
        raise AssertionError(f"observe: the instrumented registry counted "
                             f"{ {k: counted[(k, ())] for k in want} }, not {want}")
    medians = {f"{label}_median_{k}": round(float(np.median([r[k] for r in rs])), 4)
               for label, rs in runs.items() for k in ("p50_ms", "p99_ms", "rows_per_s")}
    return {"cost_members": OBSERVE_MEMBERS, "cost_rounds": OBSERVE_COST_ROUNDS, **medians,
            "cost_runs": json.dumps(runs)}


def observe_phase(card: str):
    """Serve four models at config 1's width on the card and hold /stats,
    /metrics, the quarantine breaker, deadlines and the gzipped digest to
    their contracts; then the instrumentation's cost on the closed loop."""
    shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    rng = np.random.default_rng(14)
    t0 = time.perf_counter()
    dense = random_entry("obs-dense", 10, rng)
    lstm = random_lstm_entry("obs-lstm", "LSTMAutoEncoder", rng)
    first = "layers.0.weight"
    poisoned = dataclasses.replace(dense, name="obs-nan", params={
        **dense.params, first: np.full_like(dense.params[first], np.nan)})
    for entry in (dense, lstm, poisoned):
        serializer.dump(entry, os.path.join(OBSERVE_DIR, entry.name))
    pca, metadata = build_model("obs-pca", OBSERVE_PCA, dataset("obs-pca"))
    serializer.dump(pca, os.path.join(OBSERVE_DIR, "obs-pca"), metadata=metadata)
    summary = {"build_s": round(time.perf_counter() - t0, 3)}
    server = run_server(OBSERVE_DIR, host="127.0.0.1", port=0, background=True)
    try:
        base = server.url + "/gordo/v0/smoke"
        fallback = server.app.bank.coverage()["fallback"]
        if sorted(server.app.bank._index) != ["obs-dense", "obs-lstm", "obs-nan"] or list(fallback) != ["obs-pca"]:
            raise AssertionError(f"observe: banked {sorted(server.app.bank._index)}, per model {fallback}")
        summary.update(observe_counters(server, base, rng))
        summary.update(observe_quarantine(server, base, dense, rng))
        summary.update(observe_deadlines(server, base, rng))
        summary.update(observe_held_deadlines(server, rng))
        summary.update(observe_gzip(base))
    finally:
        server.close()
        shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    summary["serve_s"] = round(time.perf_counter() - t0, 3)
    summary.update(instrumentation_cost(rng))
    phase("observe", **summary, card=json.dumps(card))
    return summary


PIPELINE_DIR = os.path.join(ROOT, "build", "chip_smoke_pipeline")
# the multi-bucket bank: config 1's width (10 tags), one bucket a family,
# PIPELINE_MEMBERS each; the bf16 LSTM bucket puts K3-bf16 on this path
PIPELINE_FAMILIES = ("dense", "lstm", "conv", "dense_bf16", "lstm_bf16")
PIPELINE_MEMBERS = 1_000
PIPELINE_BATCHES = 200  # back-to-back mixed batches at each window
PIPELINE_REQUESTS = 64  # a batch
PIPELINE_ROWS = (40, 400)  # a request's rows, drawn from a seed
PIPELINE_WINDOWS = (1, 2, 4)  # GORDO_BANK_INFLIGHT
PIPELINE_ROUNDS = 2  # rounds of (a, b, b, a): medians of 4 runs a side; cut from 5, then 3 (the smoke's wall)
PIPELINE_LOOP = dict(clients=64, requests=4, rows=128)  # the window-1/2 loop
PLANES_LOOP = dict(clients=16, requests=4, rows=64)  # the planes' loop, over HTTP
PLANES_OFF = {"GORDO_TRACE_SAMPLE": "0", "GORDO_SLO": "0", "GORDO_COST": "0"}
PIPELINE_SPANS = ("queue_wait", "coalesce", "pad", "device_execute", "postprocess")


def pipeline_entry(name: str, family: str, rng):
    if family.startswith("dense"):
        entry = random_entry(name, 10, rng)
    elif family.startswith("lstm"):
        entry = random_lstm_entry(name, "LSTMAutoEncoder", rng)
    else:
        entry = random_zoo_entry(name, "conv", rng)
    return dataclasses.replace(entry, compute_dtype=BF16) if family.endswith("bf16") else entry


def pipeline_batch(b: int):
    """Batch ``b``: PIPELINE_REQUESTS requests to random members, request i
    to family i % 5 (so the bucket groups come in one order), rows drawn
    from PIPELINE_ROWS; each family's first request is drawn from 257 up,
    so every group pads to (16, 512): the arena's shapes are the first
    batch's."""
    rng = np.random.default_rng((15, b))
    lo, hi = PIPELINE_ROWS
    out = []
    for i in range(PIPELINE_REQUESTS):
        family = PIPELINE_FAMILIES[i % len(PIPELINE_FAMILIES)]
        rows = int(rng.integers(257 if i < len(PIPELINE_FAMILIES) else lo, hi + 1))
        out.append((f"{family}-{int(rng.integers(PIPELINE_MEMBERS)):04d}",
                    rng.random((rows, 10), dtype=np.float32), None))
    return out


def result_digest(r) -> bytes:
    h = hashlib.sha1()
    for a in (r.model_output, r.diff, r.scaled, r.total_unscaled, r.total_scaled):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


@contextlib.contextmanager
def env_set(values: dict):
    """The environment with ``values`` set, restored afterwards."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ab_runs(labels, run, what: str) -> dict:
    """One untimed run a label, then PIPELINE_ROUNDS rounds of the labels
    forward and back ((a, b, b, a) for two): each label's p50, p99 and
    rows/s medians and every run's."""
    labels = list(labels)
    order = labels + (labels + labels[::-1]) * PIPELINE_ROUNDS
    runs = {label: [] for label in labels}
    for i, label in enumerate(order):
        gc.collect()
        lat, n_rows, wall = run(label)
        if i < len(labels):
            continue
        lat_ms = np.asarray(lat) * 1e3
        runs[label].append({"p50_ms": round(float(np.percentile(lat_ms, 50)), 4),
                            "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
                            "rows_per_s": round(n_rows / wall, 1)})
    medians = {f"{what}_{label}_median_{k}": round(float(np.median([r[k] for r in rs])), 4)
               for label, rs in runs.items() for k in ("p50_ms", "p99_ms", "rows_per_s")}
    return {**medians, f"{what}_runs": json.dumps(runs)}


def pipeline_bitwise(entries) -> tuple:
    """PIPELINE_BATCHES batches at each window, the bank built through
    ``GORDO_BANK_INFLIGHT``: every result bitwise window 1's; the arena's
    misses flat after the first batch; the readings."""
    from gordo_components_torch.observability.goodput import GoodputLedger

    banks, summary, reference = {}, {}, None
    for w in PIPELINE_WINDOWS:
        with env_set({"GORDO_BANK_INFLIGHT": str(w)}):
            bank = ModelBank.from_entries(entries, registry=False, ledger=GoodputLedger())
        if bank._inflight_window != w or bank.n_buckets != len(PIPELINE_FAMILIES):
            raise AssertionError(f"pipeline: window {bank._inflight_window}, {bank.n_buckets} buckets")
        gc.collect()
        digests, misses_first = [], None
        t0 = time.perf_counter()
        for b in range(PIPELINE_BATCHES):
            results = bank.score_many(pipeline_batch(b))
            if not all(np.isfinite(r.total_scaled).all() for r in results):
                raise AssertionError(f"pipeline: window {w} batch {b} scored non-finite totals")
            digests.append([result_digest(r) for r in results])
            if b == 0:
                misses_first = bank.arena.misses
        wall = time.perf_counter() - t0
        if reference is None:
            reference = digests
        else:
            moved = sum(g != r for gb, rb in zip(digests, reference) for g, r in zip(gb, rb))
            if moved:
                raise AssertionError(f"pipeline: window {w}: {moved} results not bitwise window 1's")
        arena = bank.arena.stats()
        if arena["misses"] != misses_first or arena["outstanding"] != 0:
            raise AssertionError(f"pipeline: window {w}: arena misses {misses_first} after the first batch, "
                                 f"{arena['misses']} after the last; {arena['outstanding']} outstanding")
        if not torch.from_numpy(next(iter(bank.arena._pool.values()))[0]).is_pinned():
            raise AssertionError(f"pipeline: window {w}: the arena's buffers are not page-locked")
        ledger = bank.ledger.snapshot()
        ledger_s = sum(c["useful_s"] + c["padded_s"] + c["failed_s"] for c in ledger["per_bucket"].values())
        overlap = bank.pipeline_stats()["overlap"]
        summary.update({
            f"w{w}_wall_s": round(wall, 3), f"w{w}_arena_hits": arena["hits"],
            f"w{w}_arena_misses": arena["misses"], f"w{w}_arena_misses_first_batch": misses_first,
            f"w{w}_pinned_bytes": arena["pooled_bytes"], f"w{w}_inflight_peak": bank.inflight_peak,
            f"w{w}_overlap_ratio": overlap["overlap_ratio"],
            f"w{w}_ledger_busy_ratio": ledger["device"]["busy_ratio"],
            f"w{w}_ledger_device_s": round(ledger_s, 6), f"w{w}_cuda_event_s": round(bank.event_s, 6),
        })
        banks[w] = bank
    summary["bitwise_results"] = PIPELINE_BATCHES * PIPELINE_REQUESTS * (len(PIPELINE_WINDOWS) - 1)
    return banks, summary


def pipeline_loop(banks, rng) -> dict:
    """The closed loop (PIPELINE_LOOP, random members of every bucket) on
    the mixed bank at windows 1 and 2."""
    c, n, rows = PIPELINE_LOOP["clients"], PIPELINE_LOOP["requests"], PIPELINE_LOOP["rows"]
    X = rng.random((c, n, rows, 10), dtype=np.float32)
    names = [[f"{PIPELINE_FAMILIES[int(f)]}-{int(m):04d}"
              for f, m in zip(rng.integers(0, len(PIPELINE_FAMILIES), n), rng.integers(0, PIPELINE_MEMBERS, n))]
             for _ in range(c)]

    def run(label):
        engine = BatchingEngine(banks[int(label[1:])], max_batch=64, flush_ms=2.0)
        engine.start()
        try:
            lat, results, wall = closed_loop(engine, names, X, f"pipeline {label} loop")
        finally:
            engine.stop()
        return lat, len(results) * rows, wall

    return ab_runs(("w1", "w2"), run, "loop")


def pipeline_served(rng) -> dict:
    """The served app on the card with every request traced: the stage
    spans of a POST carrying a traceparent, /traces, /traces/slow, the
    Chrome export, X-Request-Id, the exemplar, /slo, /costs (the card's
    peak, a finite MFU a bucket), /stats against /metrics, and the per-model
    detector's device_execute span with K1; then the planes on and off."""
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    banked = {f"pipe-{family}": pipeline_entry(f"pipe-{family}", family, rng)
              for family in ("dense", "lstm", "conv", "dense_bf16")}
    for name, entry in banked.items():
        serializer.dump(entry, os.path.join(PIPELINE_DIR, name))
    pca, metadata = build_model("pipe-pca", OBSERVE_PCA, dataset("pipe-pca"))
    serializer.dump(pca, os.path.join(PIPELINE_DIR, "pipe-pca"), metadata=metadata)
    summary = {}
    with env_set({"GORDO_TRACE_SAMPLE": "1"}):
        server = run_server(PIPELINE_DIR, host="127.0.0.1", port=0, background=True)
    try:
        base = server.url + "/gordo/v0/smoke"
        if sorted(server.app.bank._index) != sorted(banked):
            raise AssertionError(f"pipeline: banked {sorted(server.app.bank._index)}")
        X = rng.random((128, 10), dtype=np.float32)
        traced = {}
        for name in list(banked) + ["pipe-pca"]:
            trace_id = f"{int(rng.integers(1 << 62)):032x}"
            parent = "00-" + trace_id + "-00f067aa0ba902b7-01"
            before = launches()
            status, hdrs, body = post_anomaly(base, name, X, {"traceparent": parent})
            moved = launched(before)
            if status != 200 or not totals_finite(body).all():
                raise AssertionError(f"pipeline: {name} answered {status}")
            if hdrs.get("X-Request-Id") != trace_id or not hdrs.get("traceparent", "").startswith(f"00-{trace_id}-"):
                raise AssertionError(f"pipeline: {name}'s X-Request-Id {hdrs.get('X-Request-Id')}, "
                                     f"traceparent {hdrs.get('traceparent')}, sent {parent}")
            status, _, raw = http_raw(f"{base}/traces?id={trace_id}")
            found = json.loads(raw)["traces"]
            if status != 200 or len(found) != 1:
                raise AssertionError(f"pipeline: /traces?id={trace_id} answered {status}: {raw[:300]}")

            def names_of(node):
                return [node["name"]] + [n for child in node.get("children", ()) for n in names_of(child)]

            spans = names_of(found[0]["spans"])
            want = ("device_execute",) if name == "pipe-pca" else PIPELINE_SPANS
            if any(s not in spans for s in want):
                raise AssertionError(f"pipeline: {name}'s trace has spans {spans}")
            if name == "pipe-pca" and moved["K1"] < 1:
                raise AssertionError(f"pipeline: the per-model POST launched {moved}")
            traced[name] = spans
        summary["traced_spans"] = json.dumps(traced)
        status, _, raw = http_raw(f"{base}/traces/slow")
        slow = json.loads(raw)["traces"]
        status2, _, raw2 = http_raw(f"{base}/traces?format=chrome")
        chrome = json.loads(raw2)["traceEvents"]
        if status != 200 or not slow or status2 != 200 or not chrome:
            raise AssertionError(f"pipeline: /traces/slow {status}, chrome {status2}")
        status, _, raw = http_raw(f"{base}/slo?refresh=1")
        slo = json.loads(raw)
        status2, _, raw2 = http_raw(f"{base}/costs?refresh=1")
        costs = json.loads(raw2)
        mfu = {label: row["mfu"] for label, row in costs.get("buckets", {}).items()}
        if (status, status2) != (200, 200) or not slo.get("enabled") or not costs.get("enabled") \
                or costs["peak_source"] != "device" or len(mfu) != len(banked) \
                or not all(m is not None and math.isfinite(m) and m > 0 for m in mfu.values()):
            raise AssertionError(f"pipeline: /slo enabled {slo.get('enabled')}, /costs {raw2[:400]}")
        values = scrape(base)
        status, _, raw = http_raw(base + "/stats")
        stats = json.loads(raw)
        # the last scoring POST (the per-model one) is its latency bucket's exemplar
        exemplars = {ex["trace_id"] for ex in stats["exemplars"].get("anomaly", {}).values()}
        if trace_id not in exemplars:
            raise AssertionError(f"pipeline: /stats exemplars {stats['exemplars']} miss {trace_id}")

        def metric(name, **labels):
            return values.get((name, tuple(sorted(labels.items()))))

        pairs = {f"goodput[{c}]": (n, metric("gordo_goodput_requests_total", **{"class": c}))
                 for c, n in stats["goodput"]["requests"].items()}
        for key, cell in stats["goodput"]["tenants"].items():
            tenant, _, cls = key.partition("|")
            for outcome, n in cell.items():
                pairs[f"tenant[{key}|{outcome}]"] = (n, metric("gordo_goodput_tenant_requests_total", tenant=tenant,
                                                               outcome=outcome, **{"class": cls}))
        arena = stats["bank_pipeline"]["arena"]
        pairs["arena.hits"] = (arena["hits"], metric("gordo_bank_arena_hits_total"))
        pairs["arena.misses"] = (arena["misses"], metric("gordo_bank_arena_misses_total"))
        pairs["arena.bytes"] = (arena["pooled_bytes"], metric("gordo_bank_arena_bytes"))
        pairs["inflight"] = (0, metric("gordo_bank_inflight_groups"))
        for label, row in stats["costs"]["buckets"].items():
            pairs[f"flops_per_row[{label}]"] = (row["flops_per_row"], metric("gordo_bucket_flops_per_row",
                                                                            bucket=label))
        apart = {k: v for k, v in pairs.items() if v[0] is None or v[0] != v[1]}
        if apart or stats["goodput"]["requests"]["goodput"] != len(banked) + 1:
            raise AssertionError(f"pipeline: /stats and /metrics disagree: {apart}; {stats['goodput']['requests']}")
        summary.update({"stats_metrics_equal": len(pairs), "mfu": json.dumps(mfu),
                        "peak_flops": costs["peak_flops"], "slo_samples": slo["n_samples"],
                        "goodput": json.dumps(stats["goodput"]["device"])})
    finally:
        server.close()
    summary.update(planes_cost(list(banked), rng))
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    return summary


def http_ab(servers, labels, names, rng, what: str) -> dict:
    """The closed loop over HTTP (PLANES_LOOP, random ``names``) against
    the two ``servers`` labelled ``labels``, through :func:`ab_runs`."""
    c, n, rows = PLANES_LOOP["clients"], PLANES_LOOP["requests"], PLANES_LOOP["rows"]
    bodies = [[json.dumps({"X": rng.random((rows, 10)).tolist()}).encode() for _ in range(n)] for _ in range(c)]
    targets = [[names[int(j)] for j in rng.integers(0, len(names), n)] for _ in range(c)]

    def run(label):
        base = servers[label].url + "/gordo/v0/smoke"
        lat, failures = [], []
        barrier = threading.Barrier(c)

        def client(i):
            try:
                barrier.wait(60)
                for r in range(n):
                    t = time.perf_counter()
                    status, _, _ = http_raw(f"{base}/{targets[i][r]}/anomaly/prediction", bodies[i][r],
                                            {"Content-Type": "application/json"})
                    lat.append(time.perf_counter() - t)
                    if status != 200:
                        failures.append(status)
            except Exception as exc:
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(c)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t0
        if failures or len(lat) != c * n:
            raise AssertionError(f"{what}: the {label} loop: {len(lat)} answers, {failures[:3]}")
        return lat, c * n * rows, wall

    return ab_runs(labels, run, what)


def planes_cost(names, rng) -> dict:
    """The closed loop over HTTP (PLANES_LOOP, random banked targets)
    against a server with the tracer, ledger, SLO tracker and cost model on
    (their defaults) and one with ``GORDO_TRACE_SAMPLE=0``, ``GORDO_SLO=0``
    and ``GORDO_COST=0``."""
    servers = {"on": run_server(PIPELINE_DIR, host="127.0.0.1", port=0, background=True)}
    with env_set(PLANES_OFF):
        servers["off"] = run_server(PIPELINE_DIR, host="127.0.0.1", port=0, background=True)
    try:
        app = servers["off"].app
        if app.tracer.enabled or app.ledger is not None or app.slo is not None or app.cost is not None:
            raise AssertionError("pipeline: a plane stayed on with its knob at 0")
        return http_ab(servers, ("on", "off"), names, rng, "planes")
    finally:
        for server in servers.values():
            server.close()


def pipeline_phase(card: str):
    """The bank's pipeline on the card: a five-bucket bank of
    PIPELINE_MEMBERS a family scored at windows 1, 2 and 4, bitwise; its
    closed loop at windows 1 and 2; the served app's traces, SLOs, costs
    and new series; the planes on against off."""
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    entries = [pipeline_entry(f"{family}-{m:04d}", family, rng)
               for family in PIPELINE_FAMILIES for m in range(PIPELINE_MEMBERS)]
    summary = {"members": len(entries), "buckets": len(PIPELINE_FAMILIES), "batches": PIPELINE_BATCHES,
               "requests": PIPELINE_REQUESTS, "entries_s": round(time.perf_counter() - t0, 3)}
    banks, readings = pipeline_bitwise(entries)
    del entries
    summary.update(readings)
    summary.update(pipeline_loop(banks, rng))
    del banks
    gc.collect()
    summary.update(pipeline_served(rng))
    phase("pipeline", **summary, card=json.dumps(card))
    return summary


QOS_DIR = os.path.join(ROOT, "build", "chip_smoke_qos")
QOS_MEMBERS = 20  # config 1's dense detectors (10 tags) the served phase routes rows to
QOS_FLOOD_FAMILIES = ("dense", "lstm", "conv", "dense_bf16")
QOS_FLOOD_MEMBERS = 1_000  # a family
QOS_FLOOD = {"interactive": 64, "batch": 64, "best_effort": 512}  # requests a class, all at once
QOS_FLOOD_ROWS = 64
QOS_RUNS = 2  # flood and no flood, in turns after one untimed run each; cut from 5, then 3 (the smoke's wall)
QOS_RELOADS = 3  # warm and cold reloads, in turns; cut from 5 (the smoke's wall)
QOS_TENANT = "smoke-tenant"
QOS_ENV = {"GORDO_QOS_TENANTS": json.dumps({QOS_TENANT: {"rate": 5.0, "burst": 5}}),
           "GORDO_HISTORY": "1", "GORDO_HISTORY_INTERVAL_S": "1", "GORDO_HISTORY_TIERS": "1s@5m,1m@6h"}
QOS_PLANES_OFF = {"GORDO_HEAT": "0", "GORDO_HISTORY": "0", "GORDO_QOS_TENANTS": ""}
QOS_MAX_QUEUE = 16  # the served engine's bound: best_effort sheds from 8 waiting
QOS_HISTORY_POSTS = (3, 20)  # seconds, POSTs a second: the requests the history's rate must match
QOS_EVENTS = ("quarantine.enter", "quarantine.clear", "bank.swap", "models.reload")  # the JAX server's order


def warm_keys(bank) -> set:
    """The arena keys a warm-up fills: each bucket's (B, T, F) input and
    target, (B,) index and, on the card, its packed result, at every warm
    (T, B)."""
    rows = bank._warmup_grid_env("GORDO_WARMUP_ROWS", (256,))
    batches = bank._warmup_grid_env("GORDO_WARMUP_BATCHES", (1,))
    keys = set()
    for bucket in bank._buckets.values():
        F, off = bucket.n_features, bucket.offset
        for T, B in bank.warmup_shapes(bucket, rows, batches):
            keys |= {((B, T, F), "float32"), ((B,), "int32")}
            if bank.device.type == "cuda":
                keys.add(((B, 3 * (T - off) * F + 2 * (T - off)), "float32"))
    return keys


def arena_keys(bank) -> set:
    return {(shape, np.dtype(dtype).name) for shape, dtype in bank.arena._pool}


def flood_band(got, want, family: str, what: str) -> float:
    """A result against the same request scored alone, in the observe
    phase's bands: dense fp32 atol E2E_ATOL, LSTM and conv LSTM_RTOL /
    LSTM_ATOL, bf16 BF16_ATOL x max(1, |x|); the largest error."""
    worst = 0.0
    for a, b in zip(result_arrays(got), result_arrays(want)):
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            raise AssertionError(f"{what}: shape {a.shape} against {b.shape}, or non-finite values")
        err = float(np.abs(a - b).max()) if a.size else 0.0
        if family.endswith("bf16"):
            ok = err <= BF16_ATOL * max(1.0, float(np.abs(b).max()) if b.size else 0.0)
        elif family == "dense":
            ok = np.allclose(a, b, rtol=0.0, atol=E2E_ATOL)
        else:
            ok = np.allclose(a, b, rtol=LSTM_RTOL, atol=LSTM_ATOL)
        if not ok:
            raise AssertionError(f"{what}: off by {err} against the request alone")
        worst = max(worst, err)
    return worst


def result_arrays(r):
    return (r.model_output, r.diff, r.scaled, r.total_unscaled, r.total_scaled)


def qos_flood() -> dict:
    """The fair queue under a flood: a bank of QOS_FLOOD_MEMBERS each of
    dense, LSTM, conv and dense bf16 behind one engine; three threads
    submit QOS_FLOOD's requests at once (default weights). Each class's
    share of the dequeues while all three are backlogged against its
    weight's share; interactive p50 and p99 with and without the
    best_effort flood (medians of QOS_RUNS runs each); every result held
    to the same request scored alone."""
    from gordo_components_torch.qos.fair import DEFAULT_WEIGHTS

    rng = np.random.default_rng(16)
    t0 = time.perf_counter()
    entries = [pipeline_entry(f"{family}-{m:04d}", family, rng)
               for family in QOS_FLOOD_FAMILIES for m in range(QOS_FLOOD_MEMBERS)]
    bank = ModelBank.from_entries(entries, registry=False)
    del entries
    requests = {cls: [(f"{QOS_FLOOD_FAMILIES[int(f)]}-{int(m):04d}",
                       rng.random((QOS_FLOOD_ROWS, 10), dtype=np.float32))
                      for f, m in zip(rng.integers(0, len(QOS_FLOOD_FAMILIES), n),
                                      rng.integers(0, QOS_FLOOD_MEMBERS, n))]
                for cls, n in QOS_FLOOD.items()}
    alone = {(cls, i): bank.score(name, X) for cls, reqs in requests.items() for i, (name, X) in enumerate(reqs)}
    summary = {"flood_members": len(bank), "flood_buckets": bank.n_buckets,
               "flood_build_s": round(time.perf_counter() - t0, 3)}
    engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0, max_queue=2 * sum(QOS_FLOOD.values()))
    wfq = engine._queue
    pops = []  # (class, the backlog a class just before the pop)
    pop = wfq._pop

    def recording_pop():
        depths = {c: len(h) for c, h in wfq._heaps.items()}
        item = pop()
        pops.append((item.qos_class, depths))
        return item

    wfq._pop = recording_pop
    engine.start()
    worst = 0.0
    shares, interactive = [], {"flood": [], "no_flood": []}

    def run(label):
        nonlocal worst
        classes = [c for c in QOS_FLOOD if label == "flood" or c != "best_effort"]
        pops.clear()
        barrier = threading.Barrier(len(classes))
        futures = {c: [] for c in classes}
        failures = []

        def client(cls):
            try:
                barrier.wait(60)
                for i, (name, X) in enumerate(requests[cls]):
                    t = time.perf_counter()
                    fut = engine.submit(name, X, qos_class=cls)
                    done = []
                    fut.add_done_callback(lambda _f, done=done: done.append(time.perf_counter()))
                    futures[cls].append((i, fut, t, done))
            except Exception as exc:
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,)) for c in classes]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        lat = []
        for cls, subs in futures.items():
            for i, fut, t, done in subs:
                result = fut.result(120)
                family = requests[cls][i][0].rsplit("-", 1)[0]
                worst = max(worst, flood_band(result, alone[(cls, i)], family, f"qos flood {cls} {i}"))
                if cls == "interactive":
                    lat.append(done[0] - t)
        if failures or len(pops) != sum(len(s) for s in futures.values()):
            raise AssertionError(f"qos flood {label}: {len(pops)} dequeues, failures {failures[:3]}")
        return lat

    try:
        order = ["flood", "no_flood"] + ["flood", "no_flood", "no_flood", "flood"] * ((QOS_RUNS + 1) // 2)
        counts = {"flood": 0, "no_flood": 0}
        for i, label in enumerate(order):
            if i >= 2 and counts[label] == QOS_RUNS:
                continue
            gc.collect()
            lat = run(label)
            if label == "flood":
                busy = [cls for cls, depths in pops if all(depths.values())]
                shares.append({c: busy.count(c) / len(busy) for c in QOS_FLOOD} if busy else None)
            if i < 2:
                continue
            counts[label] += 1
            lat_ms = np.asarray(lat) * 1e3
            interactive[label].append((float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))))
    finally:
        engine.stop()
    busy_shares = [s for s in shares if s is not None]
    if not busy_shares:
        raise AssertionError("qos flood: no dequeue found all three classes backlogged")
    total = sum(DEFAULT_WEIGHTS.values())
    weight_share = {c: round(w / total, 4) for c, w in DEFAULT_WEIGHTS.items()}
    mean_share = {c: round(float(np.mean([s[c] for s in busy_shares])), 4) for c in QOS_FLOOD}
    if abs(mean_share["interactive"] - weight_share["interactive"]) > 0.1:
        raise AssertionError(f"qos flood: interactive took {mean_share} of the busy dequeues, weights {weight_share}")
    stats = engine.class_stats_snapshot()
    runs_a_side = QOS_RUNS + 1
    want = {c: n * runs_a_side * (2 if c != "best_effort" else 1) for c, n in QOS_FLOOD.items()}
    if {c: s["requests"] for c, s in stats.items()} != want:
        raise AssertionError(f"qos flood: the engine counted {stats}, not {want}")
    summary.update({
        "flood_weight_share": json.dumps(weight_share), "flood_busy_share": json.dumps(mean_share),
        "flood_busy_shares": json.dumps([{c: round(v, 4) for c, v in s.items()} for s in busy_shares]),
        "flood_vs_alone_max_err": worst,
        "flood_results_held": sum(want.values()),
    })
    for label, runs in interactive.items():
        summary[f"interactive_{label}_median_p50_ms"] = round(float(np.median([r[0] for r in runs])), 4)
        summary[f"interactive_{label}_median_p99_ms"] = round(float(np.median([r[1] for r in runs])), 4)
        summary[f"interactive_{label}_runs"] = json.dumps([[round(p50, 4), round(p99, 4)] for p50, p99 in runs])
    return summary


def qos_served() -> dict:
    """One server over QOS_MEMBERS config-1 dense detectors and a NaN copy,
    with a rate-limited tenant and the history on (1 s): heat, quarantine
    events, the C5 reloads, admission and the history's rates."""
    from gordo_components_torch.server.swap import warmup_enabled

    shutil.rmtree(QOS_DIR, ignore_errors=True)
    rng = np.random.default_rng(161)
    names = [f"qos-{i:02d}" for i in range(QOS_MEMBERS)]
    entries = {name: random_entry(name, 10, rng) for name in names}
    first = "layers.0.weight"
    nan = dataclasses.replace(entries[names[0]], name="qos-nan", params={
        **entries[names[0]].params, first: np.full_like(entries[names[0]].params[first], np.nan)})
    for entry in list(entries.values()) + [nan]:
        serializer.dump(entry, os.path.join(QOS_DIR, entry.name))
    summary = {}
    with env_set(QOS_ENV):
        server = run_server(QOS_DIR, host="127.0.0.1", port=0, background=True, bank_max_queue=QOS_MAX_QUEUE)
    try:
        app = server.app
        base = server.url + "/gordo/v0/smoke"
        if app._warmup is not None:
            app._warmup.join()
        summary.update(qos_heat(app, base, names))
        summary.update(qos_quarantine(base))
        summary.update(qos_reload_keeps_heat(app, base, names, entries))
        summary.update(qos_reload_under_load(base, names, rng))
        summary.update(qos_c5(app, base, names[-1], rng, warmup_enabled))
        summary.update(qos_admission(app, base, names))
        summary.update(qos_events_history(app, base, names, rng))
    finally:
        server.close()
    return summary


def qos_post(base, name, rows, rng, headers=None):
    status, hdrs, raw = http_raw(f"{base}/{name}/anomaly/prediction",
                                 json.dumps({"X": rng.random((rows, 10)).tolist()}).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    return status, hdrs, raw


def qos_heat(app, base, names) -> dict:
    """Member i gets QOS_MEMBERS - i POSTs of 32 rows (from 8 threads):
    ``/heat?refresh=1&top=5`` ranks the first five in order, the tiers add
    up to the members the bank holds, and the members tracked are those
    that took rows."""
    jobs = [name for i, name in enumerate(names) for _ in range(len(names) - i)]
    failures = []

    def post(i):
        r = np.random.default_rng(i)
        for name in jobs[i::8]:
            status = qos_post(base, name, 32, r)[0]
            if status != 200:
                failures.append((name, status))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    status, _, raw = http_raw(base + "/heat?refresh=1&top=5")
    heat = json.loads(raw)
    top = [e["member"] for e in heat.get("hottest", ())]
    if failures or status != 200 or top != names[:5] or sum(heat["tiers"].values()) != heat["members_total"] \
            or heat["members_total"] != len(app.bank) or heat["members_tracked"] != len(names):
        raise AssertionError(f"qos heat: failures {failures[:3]}; /heat {raw[:600]}")
    rows = {e["member"]: (len(names) - names.index(e["member"])) * 32 for e in heat["hottest"]}
    return {"heat_posts": len(jobs), "heat_top5": json.dumps(top),
            "heat_top5_rates": json.dumps([e["rate"] for e in heat["hottest"]]),
            "heat_top5_rows": json.dumps([rows[m] for m in top]), "heat_tiers": json.dumps(heat["tiers"]),
            "heat_members_tracked": heat["members_tracked"], "heat_members_total": heat["members_total"]}


def qos_quarantine(base) -> dict:
    """Three NaN answers put the NaN member in quarantine; clear re-admits it."""
    statuses = [qos_post(base, "qos-nan", 16, np.random.default_rng(i))[0] for i in range(4)]
    cleared = http_json(base + "/quarantine/clear", {"targets": ["qos-nan"]})
    if statuses != [200, 200, 200, 410] or cleared != (200, {"enabled": True, "cleared": ["qos-nan"]}):
        raise AssertionError(f"qos quarantine: {statuses}, clear {cleared}")
    return {"quarantine_statuses": json.dumps(statuses)}


def qos_reload_keeps_heat(app, base, names, entries) -> dict:
    """``/reload`` with the hottest member rewritten in bf16 (another
    bucket): before any request the new bank's arena holds the warm
    shapes; the heat ranking stands and the member's bucket is the new
    bank's."""
    before = json.loads(http_raw(base + "/heat?top=5")[2])
    serializer.dump(dataclasses.replace(entries[names[0]], compute_dtype=BF16), os.path.join(QOS_DIR, names[0]))
    status, body = http_json(base + "/reload", {})
    bank = app.bank
    keys, want = arena_keys(bank), warm_keys(bank)
    if status != 200 or body["changes"]["updated"] != [names[0]] or body["swap"]["generation"] != 1 \
            or keys != want:
        raise AssertionError(f"qos reload: {status} {body}; arena {sorted(keys)} against {sorted(want)}")
    after = json.loads(http_raw(base + "/heat?refresh=1&top=5")[2])
    label = bank._buckets[bank._index[names[0]][0]].label
    if [e["member"] for e in after["hottest"]] != [e["member"] for e in before["hottest"]] \
            or after["hottest"][0]["bucket"] != label or before["hottest"][0]["bucket"] == label:
        raise AssertionError(f"qos reload: heat {before['hottest']} -> {after['hottest']}, {names[0]} in {label}")
    return {"reload_build_s": round(bank.build_s, 4), "reload_warmup_s": round(bank.warmup_s, 4),
            "reload_arena_keys": len(keys), "reload_bucket_before": before["hottest"][0]["bucket"],
            "reload_bucket_after": label}


def qos_reload_under_load(base, names, rng) -> dict:
    """A warm reload while a thread POSTs: its answers are all 200 and none
    waits 250 ms (the flip's limit) while the new bank builds and warms."""
    lat, stop = [], threading.Event()

    def load():
        r = np.random.default_rng(0)
        while not stop.is_set():
            t = time.perf_counter()
            status = qos_post(base, names[10], 32, r)[0]
            lat.append((time.perf_counter() - t, status))

    serializer.dump(random_entry(names[5], 10, rng), os.path.join(QOS_DIR, names[5]))
    loader = threading.Thread(target=load)
    loader.start()
    try:
        time.sleep(0.2)
        status, body = http_json(base + "/reload", {})
        time.sleep(0.2)
    finally:
        stop.set()
        loader.join(60)
    worst_ms = max(t for t, _ in lat) * 1e3
    if status != 200 or body["changes"]["updated"] != [names[5]] or any(s != 200 for _, s in lat) \
            or worst_ms >= 250.0:
        raise AssertionError(f"qos reload under load: {status} {body}; the loader's answers "
                             f"{sorted(set(s for _, s in lat))}, slowest {worst_ms:.1f} ms")
    return {"reload_loader_posts": len(lat), "reload_loader_max_ms": round(worst_ms, 3)}


def qos_c5(app, base, name, rng, warmup_enabled) -> dict:
    """QOS_RELOADS reloads warm and as many with ``GORDO_SERVER_WARMUP=0``,
    in turns, each with ``name`` rewritten: the arena holds the warm
    shapes (none when cold) before the first POST (200 rows, a warm
    shape), whose latency is read."""
    first_ms = {"warm": [], "cold": []}
    times = {"build_s": [], "warmup_s": []}
    for i in range(QOS_RELOADS):
        for label in ("warm", "cold") if i % 2 == 0 else ("cold", "warm"):
            serializer.dump(random_entry(name, 10, rng), os.path.join(QOS_DIR, name))
            with env_set({"GORDO_SERVER_WARMUP": "1" if label == "warm" else "0"}):
                if warmup_enabled() != (label == "warm"):
                    raise AssertionError("qos c5: GORDO_SERVER_WARMUP not read")
                status, body = http_json(base + "/reload", {})
            bank = app.bank
            keys = arena_keys(bank)
            if status != 200 or body["changes"]["updated"] != [name] or \
                    keys != (warm_keys(bank) if label == "warm" else set()):
                raise AssertionError(f"qos c5 {label}: {status} {body}; arena {sorted(keys)}")
            if label == "warm":
                times["build_s"].append(bank.build_s)
                times["warmup_s"].append(bank.warmup_s)
            t = time.perf_counter()
            status = qos_post(base, name, 200, rng)[0]
            first_ms[label].append((time.perf_counter() - t) * 1e3)
            if status != 200:
                raise AssertionError(f"qos c5 {label}: the first POST answered {status}")
    out = {f"c5_first_post_{label}_median_ms": round(float(np.median(v)), 4) for label, v in first_ms.items()}
    out.update({f"c5_first_post_{label}_ms": json.dumps([round(x, 4) for x in v]) for label, v in first_ms.items()})
    out.update({f"c5_{k}": json.dumps([round(x, 4) for x in v]) for k, v in times.items()})
    return out


def qos_admission(app, base, names) -> dict:
    """The tenant's sixth POST in a second answers 429 ``tenant_rate`` with
    ``Retry-After``; with the engine held and its queue at best_effort's
    shed fraction a best_effort POST answers 429 ``queue_pressure``; then
    ``/qos``'s counters equal the ``gordo_qos_*`` and
    ``gordo_engine_class_*`` integers of ``/metrics``."""
    tenant = [qos_post(base, names[1], 8, np.random.default_rng(i), {"X-Gordo-Tenant": QOS_TENANT})
              for i in range(6)]
    statuses = [s for s, _, _ in tenant]
    refused = json.loads(tenant[-1][2])
    if statuses != [200] * 5 + [429] or refused.get("reason") != "tenant_rate" \
            or not tenant[-1][1].get("Retry-After"):
        raise AssertionError(f"qos admission: the tenant's POSTs answered {statuses}: {refused}")
    engine, bank = app.engine, app.bank
    gate, entered = threading.Event(), threading.Event()
    score_many = bank.score_many

    def held(*args, **kwargs):
        entered.set()
        gate.wait(60)
        return score_many(*args, **kwargs)

    bank.score_many = held
    X = np.random.default_rng(5).random((8, 10), dtype=np.float32)
    threshold = math.ceil(app.admission.shed_fractions["best_effort"] * engine.max_queue)
    futures = []
    try:
        futures.append(engine.submit(names[2], X, qos_class="batch"))
        if not entered.wait(30):  # the worker holds the first request
            raise AssertionError("qos admission: the engine took no request")
        futures += [engine.submit(names[2], X, qos_class="batch") for _ in range(threshold)]
        status, hdrs, raw = qos_post(base, names[3], 8, np.random.default_rng(9),
                                     {"X-Gordo-Priority": "best_effort"})
    finally:
        gate.set()
        del bank.score_many
    shed = json.loads(raw)
    for fut in futures:
        fut.result(60)
    if status != 429 or shed.get("reason") != "queue_pressure" or not hdrs.get("Retry-After"):
        raise AssertionError(f"qos admission: best_effort at depth {threshold} answered {status}: {shed}")
    values = scrape(base)
    qos = json.loads(http_raw(base + "/qos")[2])

    def metric(name, **labels):
        return values.get((name, tuple(sorted(labels.items()))))

    pairs = {}
    for key, n in qos["admission"]["admitted"].items():
        t, c = key.split("|")
        pairs[f"admitted[{key}]"] = (n, metric("gordo_qos_admitted_total", tenant=t, **{"class": c}))
    for key, n in qos["admission"]["shed"].items():
        t, c, r = key.split("|")
        pairs[f"shed[{key}]"] = (n, metric("gordo_qos_shed_total", tenant=t, reason=r, **{"class": c}))
    pairs["unknown_tenants"] = (qos["admission"]["unknown_tenants"], metric("gordo_qos_unknown_tenant_total"))
    for c, cell in qos["engine"]["classes"].items():
        for k, name in (("requests", "requests_total"), ("shed", "shed_total"),
                        ("deadline_expired", "deadline_expired_total")):
            pairs[f"engine[{c}].{k}"] = (cell[k], metric(f"gordo_engine_class_{name}", **{"class": c}))
    apart = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if apart or len(qos["admission"]["shed"]) != 2:
        raise AssertionError(f"qos admission: /qos and /metrics disagree: {apart}; {qos['admission']['shed']}")
    return {"tenant_statuses": json.dumps(statuses), "tenant_retry_after": tenant[-1][1]["Retry-After"],
            "pressure_depth": threshold, "pressure_retry_after": hdrs["Retry-After"],
            "qos_metrics_equal": len(pairs), "qos_shed": json.dumps(qos["admission"]["shed"]),
            "qos_classes": json.dumps(qos["engine"]["classes"])}


def qos_events_history(app, base, names, rng) -> dict:
    """``/events`` has the quarantine's enter and clear, then every
    reload's ``bank.swap`` and ``models.reload``, each with its generation;
    a steady QOS_HISTORY_POSTS of POSTs, and the history's
    ``gordo_server_requests_total{kind="anomaly"}`` rate integrated over
    its points counts them within one interval's POSTs; the store stays
    under its memory bound."""
    status, _, raw = http_raw(base + "/events?type=" + ",".join(QOS_EVENTS))
    events = json.loads(raw)["events"]
    types = [e["type"] for e in events]
    reloads = 2 + 2 * QOS_RELOADS
    want = list(QOS_EVENTS[:2]) + list(QOS_EVENTS[2:]) * reloads
    gens = [e["generation"] for e in events]
    if status != 200 or types != want or gens != [0, 0] + [g for g in range(1, reloads + 1) for _ in range(2)]:
        raise AssertionError(f"qos events: {types} at generations {gens}")
    seconds, per_s = QOS_HISTORY_POSTS
    time.sleep(1.5)  # an interval without POSTs before the counted ones
    t0 = time.time()
    sent = 0
    for i in range(seconds * per_s):
        time.sleep(max(0.0, t0 + i / per_s - time.time()))
        if qos_post(base, names[i % len(names)], 16, rng)[0] != 200:
            raise AssertionError("qos history: a POST failed")
        sent += 1
    time.sleep(2.5)  # the last POSTs sampled
    status, _, raw = http_raw(base + "/history?series=gordo_server_requests_total")
    body = json.loads(raw)
    key = 'gordo_server_requests_total{kind="anomaly"}:rate'
    points = body["series"][key]["points"] if status == 200 else []
    # a rate times its interval is the interval's POSTs: their sum over
    # the samples after t0 counts the POSTs since (the 1.5 s before t0 held
    # none, so the sample before t0 closed every earlier one)
    window = [(t, r, t_prev) for (t_prev, _), (t, r) in zip(points, points[1:]) if t > t0 and r is not None]
    counted = sum(r * (t - t_prev) for t, r, t_prev in window)
    history = body if status == 200 else {}
    if status != 200 or abs(counted - sent) > per_s or history["memory_bytes"] > history["max_bytes"]:
        raise AssertionError(f"qos history: {sent} POSTs, {counted} counted by the rates; {raw[:400]}")
    return {"events": len(events), "history_posts": sent, "history_counted": round(counted, 4),
            "history_points": len(window), "history_samples": history["samples"],
            "history_series": history["n_series"], "history_memory_bytes": history["memory_bytes"],
            "history_max_bytes": history["max_bytes"]}


def qos_planes(rng) -> dict:
    """The pipeline phase's HTTP closed loop (PLANES_LOOP) against a server
    with the new planes off (``GORDO_HEAT=0``, no history, no tenants) and
    one with all on (QOS_ENV, heat on)."""
    servers = {}
    with env_set({**QOS_ENV, "GORDO_HEAT": "1"}):
        servers["on"] = run_server(QOS_DIR, host="127.0.0.1", port=0, background=True)
    with env_set(QOS_PLANES_OFF):
        servers["off"] = run_server(QOS_DIR, host="127.0.0.1", port=0, background=True)
    try:
        off, on = servers["off"].app, servers["on"].app
        if off.heat is not None or off.history is not None or off.admission.buckets \
                or on.heat is None or on.history is None or not on.admission.buckets:
            raise AssertionError("qos planes: a plane is not as its knobs say")
        names = sorted(n for n in on.bank._index if n != "qos-nan")
        return http_ab(servers, ("off", "on"), names, rng, "qos_planes")
    finally:
        for server in servers.values():
            server.close()


def qos_phase(card: str):
    """QoS, heat, events and history on the card, C5's warm reloads, and
    the new planes on against off."""
    summary = qos_flood()
    gc.collect()
    summary.update(qos_served())
    summary.update(qos_planes(np.random.default_rng(162)))
    shutil.rmtree(QOS_DIR, ignore_errors=True)
    phase("qos", **summary, card=json.dumps(card))
    return summary


WIRE_DIR = os.path.join(ROOT, "build", "chip_smoke_wire")
WIRE_DENSE = 16  # config 1's dense detectors (10 tags)
WIRE_LSTM = 4  # lstm_hourglass detectors at 10 tags, lookback 32
WIRE_ROWS = 64  # rows a request
WIRE_TENANT = "wire-tenant"
# the ring's 16 slots let the 16 clients of the loop each hold one
WIRE_ENV = {"GORDO_QOS_TENANTS": json.dumps({WIRE_TENANT: {"rate": 0.01, "burst": 1}}), "GORDO_SHM_SLOTS": "16"}
WIRE_WORKERS = 4
WIRE_CONNECTIONS = 64  # at once, one tensor POST each: the workers' check
WIRE_WORKERS_LOOP = dict(clients=64, requests=2, rows=64)  # the workers' reading
TENSOR_HEADERS = {"Content-Type": TENSOR_CONTENT_TYPE}
JSON_HEADERS = {"Content-Type": "application/json"}


class UnixHTTPConnection(http.client.HTTPConnection):
    """HTTP over a Unix-domain socket at ``path``."""

    def __init__(self, path: str, timeout: float = 120):
        super().__init__("localhost", timeout=timeout)
        self.unix_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.unix_path)
        self.sock = sock


def uds_raw(path: str, url: str, raw: bytes = None, headers=None):
    """(status, headers, body bytes) of one request over a new connection
    to the Unix socket ``path``."""
    conn = UnixHTTPConnection(path)
    try:
        conn.request("POST" if raw is not None else "GET", url, body=raw, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def tensor_body(X, meta=None) -> bytes:
    frames = [("X", X)]
    if meta is not None:
        frames.insert(0, ("__meta__", np.frombuffer(json.dumps(meta).encode(), np.uint8)))
    return pack_frames(frames)


def json_as_frames(answer: dict, prediction: bool) -> dict:
    """A JSON answer's values as the tensor answer's frames, in float64."""
    if prediction:
        return {"data": np.asarray(answer["data"], np.float64)}
    data = answer["data"]
    out = {}
    for name in ANOMALY_FRAME_NAMES:
        if name.startswith("total"):
            out[name] = np.asarray(data[name], np.float64)
        else:
            out[name] = np.stack([np.asarray(col, np.float64) for col in data[name].values()], axis=1)
    return out


def wire_json_vs_tensor(bases, names, rng) -> dict:
    """Each family (dense, LSTM) on each path (the bank; the per-model
    server, K1) and endpoint: a JSON POST and its tensor twin, the tensor
    answer's arrays bitwise the JSON answer's values."""
    checked = []
    for path, base in bases.items():
        for family, name in (("dense", names["dense"][0]), ("lstm", names["lstm"][0])):
            X = rng.random((WIRE_ROWS, 10), dtype=np.float32)
            for endpoint in ("anomaly/prediction", "prediction"):
                url = f"{base}/{name}/{endpoint}"
                s1, _, raw_json = http_raw(url, json.dumps({"X": X.tolist()}).encode(), JSON_HEADERS)
                s2, hdrs, raw_tensor = http_raw(url, tensor_body(X), TENSOR_HEADERS)
                what = f"wire {path} {family} {endpoint}"
                if (s1, s2) != (200, 200) or hdrs.get("Content-Type") != TENSOR_CONTENT_TYPE:
                    raise AssertionError(f"{what}: JSON {s1}, tensor {s2} {hdrs.get('Content-Type')}: {raw_tensor[:300]}")
                frames = unpack_frames(raw_tensor)
                meta = json.loads(frames.pop("__meta__").tobytes())
                want = json_as_frames(json.loads(raw_json), endpoint == "prediction")
                rows = len(next(iter(frames.values())))
                if list(frames) != list(want) or meta["offset"] != WIRE_ROWS - rows or not all(
                        frames[k].dtype == np.float32 and np.all(np.isfinite(frames[k]))
                        and np.array_equal(frames[k].astype(np.float64), want[k]) for k in want):
                    raise AssertionError(f"{what}: the tensor answer is not the JSON answer's float32 ({meta})")
                checked.append(what)
    return {"json_vs_tensor_bitwise": len(checked)}


def wire_transports(pool, client, names, rng) -> dict:
    """One tensor body over TCP, the Unix socket and the ring: the same
    bytes; a truncated body 400 with the reason over each; a quarantined
    target 410 over the socket and the ring; a ``__meta__`` tenant over its
    bucket 429 on the ring."""
    base = pool.url + "/gordo/v0/smoke"
    X = rng.random((WIRE_ROWS, 10), dtype=np.float32)
    for name, endpoint in ((names["dense"][0], "anomaly"), (names["lstm"][0], "anomaly"),
                           (names["dense"][1], "prediction"), (names["lstm"][1], "prediction")):
        body = tensor_body(X)
        url = f"/gordo/v0/smoke/{name}/{'anomaly/prediction' if endpoint == 'anomaly' else 'prediction'}"
        tcp = http_raw(pool.url + url, body, TENSOR_HEADERS)
        uds = uds_raw(pool.uds_path, url, body, TENSOR_HEADERS)
        ring = client.request(name, body, endpoint, 120)
        if (tcp[0], uds[0], ring[0]) != (200, 200, 200) or not tcp[2] == uds[2] == ring[1]:
            raise AssertionError(f"wire transports {name} {endpoint}: {tcp[0]} {uds[0]} {ring[0]}, "
                                 f"bytes equal {tcp[2] == uds[2]}, {tcp[2] == ring[1]}")
    name = names["dense"][2]
    url = f"/gordo/v0/smoke/{name}/anomaly/prediction"
    bad = tensor_body(X)[:-5]
    answers = {"tcp": http_raw(pool.url + url, bad, TENSOR_HEADERS)[::2], "uds": uds_raw(pool.uds_path, url, bad,
                                                                                         TENSOR_HEADERS)[::2],
               "ring": client.request(name, bad, "anomaly", 120)}
    for transport, (status, raw) in answers.items():
        if status != 400 or not json.loads(raw)["error"].startswith("tensor body: truncated body"):
            raise AssertionError(f"wire {transport}: a truncated body answered {status}: {raw[:300]}")
    quarantine = pool.app.quarantine
    for _ in range(quarantine.threshold):
        quarantine.record_failure(name, "wire smoke poison")
    try:
        gone = {"uds": uds_raw(pool.uds_path, url, tensor_body(X), TENSOR_HEADERS)[::2],
                "ring": client.request(name, tensor_body(X), "anomaly", 120)}
    finally:
        quarantine.clear([name])
    for transport, (status, raw) in gone.items():
        if status != 410 or json.loads(raw).get("reason") != "wire smoke poison":
            raise AssertionError(f"wire {transport}: a quarantined target answered {status}: {raw[:300]}")
    meta = tensor_body(X, {"tenant": WIRE_TENANT})
    tenant = [client.request(name, meta, "anomaly", 120) for _ in range(2)]
    refused = json.loads(tenant[1][1]) if tenant[1][0] == 429 else {}
    if [s for s, _ in tenant] != [200, 429] or refused.get("reason") != "tenant_rate":
        raise AssertionError(f"wire ring: the tenant's POSTs answered {[s for s, _ in tenant]}: {tenant[1][1][:300]}")
    stats = json.loads(http_raw(base + "/stats")[2])
    if stats["transports"] != {"uds": pool.uds_path, "shm": pool.shm_ring_name} or stats["shm"]["errors"] != 3:
        raise AssertionError(f"wire: /stats transports {stats.get('transports')}, shm {stats.get('shm')}")
    return {"transports_bitwise": 4, "shm_stats": json.dumps(stats["shm"])}


def wire_loop(send, names, rng, clients: int, requests: int, rows: int, what: str):
    """A closed loop of ``clients`` threads x ``requests`` requests of
    ``rows`` rows to random ``names``: ``run(label)`` for :func:`ab_runs`,
    each request ``send[label](target, X)`` -> (status, answer bytes), and
    the answer bytes a request by label."""
    data = [[rng.random((rows, 10), dtype=np.float32) for _ in range(requests)] for _ in range(clients)]
    targets = [[names[int(j)] for j in rng.integers(0, len(names), requests)] for _ in range(clients)]
    answer_bytes = {label: [] for label in send}

    def run(label):
        lat, failures, sizes = [], [], []
        barrier = threading.Barrier(clients)

        def client(i):
            try:
                barrier.wait(60)
                for r in range(requests):
                    t = time.perf_counter()
                    status, raw = send[label](targets[i][r], data[i][r])
                    lat.append(time.perf_counter() - t)
                    sizes.append(len(raw))
                    if status != 200:
                        failures.append(status)
            except Exception as exc:
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t0
        if failures or len(lat) != clients * requests:
            raise AssertionError(f"{what}: the {label} loop: {len(lat)} answers, {failures[:3]}")
        answer_bytes[label].append(float(np.mean(sizes)))
        return lat, clients * requests * rows, wall

    return run, answer_bytes


def wire_readings(pool, client, names, rng) -> dict:
    """PR 15's HTTP loop (PLANES_LOOP) JSON against tensor over TCP, with
    the ``parse`` span's median by encoding and the answer bytes a request;
    then tensor over TCP against the Unix socket against the ring."""
    app = pool.app
    tcp = pool.url + "/gordo/v0/smoke"
    anomaly = "anomaly/prediction"

    def post_json(name, X):
        return http_raw(f"{tcp}/{name}/{anomaly}", json.dumps({"X": X.tolist()}).encode(), JSON_HEADERS)[::2]

    def post_tensor(name, X):
        return http_raw(f"{tcp}/{name}/{anomaly}", tensor_body(X), TENSOR_HEADERS)[::2]

    def post_uds(name, X):
        return uds_raw(pool.uds_path, f"/gordo/v0/smoke/{name}/{anomaly}", tensor_body(X), TENSOR_HEADERS)[::2]

    def post_ring(name, X):
        return client.request(name, tensor_body(X), "anomaly", 120)

    c, n, rows = PLANES_LOOP["clients"], PLANES_LOOP["requests"], PLANES_LOOP["rows"]
    seen = {t.trace_id for t in app.tracer.recent()}
    parse_ms = {"json": [], "tensor": []}
    run, sizes = wire_loop({"json": post_json, "tensor": post_tensor}, names, rng, c, n, rows, "wire json/tensor")

    def traced_run(label):
        out = run(label)
        for trace in app.tracer.recent():
            if trace.trace_id in seen:
                continue
            seen.add(trace.trace_id)
            for span in trace.spans:
                if span.name == "parse":
                    parse_ms[span.attributes["encoding"]].append(span.duration_s * 1e3)
        return out

    summary = ab_runs(("json", "tensor"), traced_run, "wire_encoding")
    for enc, values in parse_ms.items():
        if not values:
            raise AssertionError(f"wire: no traced parse span of {enc}")
        summary[f"wire_parse_{enc}_median_ms"] = round(float(np.median(values)), 4)
        summary[f"wire_parse_{enc}_spans"] = len(values)
        summary[f"wire_answer_{enc}_bytes"] = round(float(np.mean(sizes[enc])), 1)
    run, _ = wire_loop({"tcp": post_tensor, "uds": post_uds, "ring": post_ring}, names, rng, c, n, rows,
                       "wire transports")
    summary.update(ab_runs(("tcp", "uds", "ring"), run, "wire_transport"))
    return summary


def wire_workers(names, rng) -> dict:
    """WIRE_CONNECTIONS tensor POSTs at once, each on its own connection,
    to a WIRE_WORKERS-worker server and to a 1-worker server, both scoring
    every request alone (``bank_max_batch=1``, so a result does not depend
    on which requests share a group): every worker counts some, and the
    answers are bitwise equal request by request. Then the workers' reading
    (WIRE_WORKERS_LOOP of tensor POSTs over TCP), 1 worker against
    WIRE_WORKERS, with the default batching."""
    requests = [(names[int(j)], rng.random((WIRE_ROWS, 10), dtype=np.float32))
                for j in rng.integers(0, len(names), WIRE_CONNECTIONS)]

    def burst(server):
        answers = [None] * len(requests)
        barrier = threading.Barrier(len(requests))

        def one(i):
            name, X = requests[i]
            barrier.wait(60)
            answers[i] = http_raw(f"{server.url}/gordo/v0/smoke/{name}/anomaly/prediction", tensor_body(X),
                                  TENSOR_HEADERS)[::2]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        return answers

    alone = dict(bank_max_batch=1, bank_max_queue=2 * WIRE_CONNECTIONS)
    servers = {1: run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True, workers=1, **alone)}
    try:
        servers[WIRE_WORKERS] = run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True,
                                           workers=WIRE_WORKERS, **alone)
        many, one = burst(servers[WIRE_WORKERS]), burst(servers[1])
        app = servers[WIRE_WORKERS].app
        with app.stats_lock:
            counted = dict(app.stats["workers"])
    finally:
        for server in servers.values():
            server.close()
    if any(a is None or a[0] != 200 for a in many + one) or any(a[1] != b[1] for a, b in zip(many, one)):
        raise AssertionError(f"wire workers: statuses {sorted(set(a and a[0] for a in many + one))}, "
                             f"{sum(a[1] != b[1] for a, b in zip(many, one) if a and b)} answers apart")
    if sorted(counted) != [f"w{i}" for i in range(WIRE_WORKERS)] or min(counted.values()) <= 0 \
            or sum(counted.values()) != WIRE_CONNECTIONS:
        raise AssertionError(f"wire workers: each worker's requests {counted}")
    summary = {"workers_counted": json.dumps(counted), "workers_bitwise": len(many)}
    servers = {"w1": run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True, workers=1)}
    try:
        servers[f"w{WIRE_WORKERS}"] = run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True,
                                                 workers=WIRE_WORKERS)

        def sender(server):
            return lambda name, X: http_raw(f"{server.url}/gordo/v0/smoke/{name}/anomaly/prediction",
                                            tensor_body(X), TENSOR_HEADERS)[::2]

        loop = WIRE_WORKERS_LOOP
        run, _ = wire_loop({label: sender(server) for label, server in servers.items()}, names, rng,
                           loop["clients"], loop["requests"], loop["rows"], "wire workers")
        summary.update(ab_runs(list(servers), run, "wire_workers"))
    finally:
        for server in servers.values():
            server.close()
    return summary


def wire_phase(card: str):
    """The tensor wire format and the local transports on the card: config
    1's width (10 tags), WIRE_DENSE dense and WIRE_LSTM ``lstm_hourglass``
    detectors, served banked behind a pool with a Unix socket and the ring
    (K2, K3) and per model by a second server with ``GORDO_SERVER_BANK=0``
    (K1, K3)."""
    shutil.rmtree(WIRE_DIR, ignore_errors=True)
    rng = np.random.default_rng(17)
    names = {"dense": [f"wire-dense-{i:02d}" for i in range(WIRE_DENSE)],
             "lstm": [f"wire-lstm-{i}" for i in range(WIRE_LSTM)]}
    for name in names["dense"]:
        serializer.dump(random_entry(name, 10, rng), os.path.join(WIRE_DIR, name))
    for name in names["lstm"]:
        serializer.dump(random_lstm_entry(name, "LSTMAutoEncoder", rng), os.path.join(WIRE_DIR, name))
    everyone = names["dense"] + names["lstm"]
    uds_dir = WIRE_DIR if len(os.path.join(WIRE_DIR, "w.sock").encode()) < 100 else tempfile.mkdtemp(prefix="gw")
    ring = f"gordo-smoke-{os.getpid()}"
    summary = {}
    with env_set(WIRE_ENV):
        pool = run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True,
                          uds_path=os.path.join(uds_dir, "w.sock"), shm_ring=ring)
    try:
        with env_set({"GORDO_SERVER_BANK": "0"}):
            per_model = run_server(WIRE_DIR, host="127.0.0.1", port=0, background=True)
        try:
            client = ShmRingClient(ring)
            try:
                if sorted(pool.app.bank._index) != sorted(everyone) or per_model.app.bank is not None:
                    raise AssertionError(f"wire: banked {sorted(pool.app.bank._index)}")
                if pool.app._warmup is not None:
                    pool.app._warmup.join()
                summary.update(wire_json_vs_tensor({"bank": pool.url + "/gordo/v0/smoke",
                                                    "per_model": per_model.url + "/gordo/v0/smoke"}, names, rng))
                summary.update(wire_transports(pool, client, names, rng))
                summary.update(wire_readings(pool, client, everyone, rng))
            finally:
                client.close()
        finally:
            per_model.close()
    finally:
        pool.close()
    summary.update(wire_workers(everyone, rng))
    shutil.rmtree(WIRE_DIR, ignore_errors=True)
    if uds_dir != WIRE_DIR:
        shutil.rmtree(uds_dir, ignore_errors=True)
    phase("wire", **summary, card=json.dumps(card))
    return summary



# ------------------------------------------------------------------ #
# the bulk client
# ------------------------------------------------------------------ #

CLIENT_DIR = os.path.join(ROOT, "build", "chip_smoke_client")
CLIENT_DENSE = 16  # config 1's dense detectors (10 tags)
CLIENT_LSTM = 4  # lstm_hourglass detectors at 10 tags, lookback 32
CLIENT_TAGS = [f"tag-{i}" for i in range(10)]
CLIENT_DATASET = {"type": "RandomDataset", "tag_list": CLIENT_TAGS, "resolution": "10min"}
CLIENT_RANGE = ("2020-01-01T00:00:00Z", "2020-01-05T00:00:00Z")
CLIENT_ROWS = 576  # CLIENT_RANGE's rows at 10 min
CLIENT_BATCH = 100  # rows a chunk: 6 chunks a target, each past the LSTM's 31-row warm-up
CLIENT_ROUNDS = 2  # timed bulk runs a rung, cut from 3 (the smoke's wall)
CLIENT_RUNGS = {  # the bulk run's transport and encoding
    "tcp_json": dict(transport="tcp", use_tensor=False, use_parquet=False),
    "tcp_tensor": dict(transport="tcp", use_tensor=True),
    "uds_tensor": dict(transport="uds", use_tensor=True),
    "shm_tensor": dict(transport="shm", use_tensor=True),
}
CLIENT_TENANT = "client-shed"
CLIENT_SHED_TARGETS = 4  # dense targets the shed tenant scores (24 chunks)
CLIENT_ENV = {"GORDO_QOS_TENANTS": json.dumps({CLIENT_TENANT: {"rate": 4.0, "burst": 4}}), "GORDO_SHM_SLOTS": "16"}
CLIENT_BANDS = {"dense": dict(rtol=0.0, atol=1e-5), "lstm": dict(rtol=1e-5, atol=1e-6)}


def client_columns(tags) -> list:
    return [(top, t) for top in ANOMALY_FRAME_NAMES[:4] for t in tags] + [(top, "") for top in ANOMALY_FRAME_NAMES[4:]]


def client_reference(dataset: dict, span, batch: int, paths: dict) -> dict:
    """Each target's frame as the client would join it, from its
    detector's ``anomaly()`` here a chunk of ``batch`` rows at a time over
    ``span`` of ``dataset``: (values float32, index ns)."""
    start, end = span
    X, _ = get_dataset({**dataset, "train_start_date": start, "train_end_date": end}).get_data()
    out = {}
    for name, path in paths.items():
        model = serializer.load(path)
        values, index = [], []
        for i in range(0, len(X), batch):
            arrays = model.anomaly(X.values[i:i + batch])
            rows = len(arrays["total-anomaly-scaled"])
            values.append(np.column_stack([np.asarray(arrays[k], np.float32) for k in ANOMALY_FRAME_NAMES]))
            index.append(X.index[i:i + batch][-rows:])
        out[name] = (np.concatenate(values), np.concatenate(index).view(np.int64))
    return out


def hold_client_frames(results, reference, what: str) -> dict:
    """Every target of a run ok and within its family's band of
    ``anomaly()``; the frames by target."""
    frames = {}
    for r in results:
        if not r.ok:
            raise AssertionError(f"client {what}: {r.name} failed: {r.error_messages[:2]}")
        f = r.predictions
        want, index = reference[r.name]
        band = CLIENT_BANDS["lstm" if "lstm" in r.name else "dense"]
        if (f.values.dtype != np.float64 or f.values.shape != want.shape or f.columns != client_columns(CLIENT_TAGS)
                or not np.array_equal(f.index.view(np.int64), index) or not np.all(np.isfinite(f.values))):
            raise AssertionError(f"client {what}: {r.name} frame {f.values.shape} of {f.values.dtype}, "
                                 f"want {want.shape}; index equal {np.array_equal(f.index.view(np.int64), index)}")
        if not np.allclose(f.values, want.astype(np.float64), **band):
            raise AssertionError(f"client {what}: {r.name} off anomaly() by {float(np.abs(f.values - want).max())} "
                                 f"({band})")
        frames[r.name] = f
    return frames


def client_run(what: str, **kwargs):
    """One ``Client.predict`` over the range; (client, results, wall s)."""
    c = Client("smoke", batch_size=CLIENT_BATCH, **kwargs)
    t = time.perf_counter()
    results = c.predict(*CLIENT_RANGE)
    return c, results, time.perf_counter() - t


def client_bulk(pool, per_model, names, reference, rows: int):
    """Every target over the four rungs: CLIENT_ROUNDS timed runs of 10
    chunks at once each, the rungs' order rotated a round, each held
    against ``anomaly()``; then a run of one chunk at a time each, bitwise
    the others (concurrent chunks share bank groups, whose shapes move the
    card's products in the last bits); and over the per-model server, whose
    own run must launch K1. The readings, and the first rung's frames."""
    summary, frames, timed = {}, {}, {}
    walls = {rung: [] for rung in CLIENT_RUNGS}
    order = list(CLIENT_RUNGS)
    for r in range(CLIENT_ROUNDS):
        for rung in order[r % len(order):] + order[:r % len(order)]:
            kwargs = CLIENT_RUNGS[rung]
            c, results, wall = client_run(rung, base_url=pool.url, **kwargs)
            if c.transport_used != rung.split("_")[0]:
                raise AssertionError(f"client {rung}: the run went over {c.transport_used}")
            got = hold_client_frames(results, reference, f"{rung} round {r}")
            stats = c.wire_stats
            enc = rung.split("_")[1]
            if list(stats) != [enc] or stats[enc]["rows"] != rows:
                raise AssertionError(f"client {rung}: wire stats {stats}")
            walls[rung].append(round(wall, 4))
            if r == 0:
                timed[rung] = got
                summary[rung] = {"bytes_per_row": round(stats[enc]["bytes_out"] / stats[enc]["rows"], 2)}
    for rung, kwargs in CLIENT_RUNGS.items():
        _, serial, serial_wall = client_run(rung, base_url=pool.url, parallelism=1, **kwargs)
        frames[rung] = hold_client_frames(serial, reference, f"{rung} one at a time")
        median = float(np.median(walls[rung]))
        summary[rung].update(walls_s=walls[rung], median_rows_per_s=round(rows / median, 2),
                             serial_wall_s=round(serial_wall, 4), serial_rows_per_s=round(rows / serial_wall, 2))
    first = frames["tcp_json"]
    for rung, got in frames.items():
        for name in names:
            if not np.array_equal(got[name].values, first[name].values):
                raise AssertionError(f"client {rung}: {name} is not bitwise the tcp_json run")
        summary[rung]["timed_targets_bitwise_serial"] = sum(
            np.array_equal(timed[rung][n].values, first[n].values) for n in names)
    before = launches()
    c, results, wall = client_run("per_model", base_url=per_model.url, transport="tcp", use_tensor=True)
    per_model_launches = launched(before)
    hold_client_frames(results, reference, "per_model")
    if per_model_launches["K1"] <= 0:
        raise AssertionError(f"client per_model: the run launched {per_model_launches}")
    summary["per_model_tensor"] = {"wall_s": round(wall, 4), "rows_per_s": round(rows / wall, 2),
                                   "launches": per_model_launches}
    return summary, first


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def client_shedding(pool, names, reference) -> dict:
    """A tenant over its bucket: each retry sleeps at least the answer's
    ``Retry-After``, and the server sees no more POSTs than the chunks and
    the retries the budget admitted."""
    targets = names[:CLIENT_SHED_TARGETS]
    records = _Records()
    log = logging.getLogger("gordo_components_torch.client.io")
    log.addHandler(records)
    try:
        c = Client("smoke", base_url=pool.url, batch_size=CLIENT_BATCH, tenant=CLIENT_TENANT, transport="tcp",
                   use_tensor=True, parallelism=8)
        t = time.perf_counter()
        results = c.predict(*CLIENT_RANGE, targets=targets)
        wall = time.perf_counter() - t
    finally:
        log.removeHandler(records)
    qos = pool.app.admission.snapshot()
    admitted = sum(n for k, n in qos["admitted"].items() if k.startswith(CLIENT_TENANT + "|"))
    shed = sum(n for k, n in qos["shed"].items() if k.startswith(CLIENT_TENANT + "|"))
    budget = c.retry_budget.snapshot()
    chunks = len(targets) * -(-CLIENT_ROWS // CLIENT_BATCH)
    retries = [r for r in records.records if r.getMessage().startswith("Request POST") and len(r.args) == 6]
    waits = [(float(r.args[2].headers.get("Retry-After")), float(r.args[5])) for r in retries
             if getattr(r.args[2], "status", None) == 429]
    if not waits or any(delay < hinted for hinted, delay in waits):
        raise AssertionError(f"client shed: retry sleeps against Retry-After {waits}")
    if admitted + shed != chunks + budget["retries_allowed"] or shed == 0:
        raise AssertionError(f"client shed: {admitted} admitted + {shed} shed POSTs for {chunks} chunks and "
                             f"{budget['retries_allowed']} retries")
    if budget["retries_allowed"] > 10 + c.retry_budget.ratio * budget["requests"]:
        raise AssertionError(f"client shed: {budget} past the budget's bound")
    ok = [r for r in results if r.ok]
    for r in ok:
        want, _ = reference[r.name]
        if not np.allclose(r.predictions.values, want.astype(np.float64), **CLIENT_BANDS["dense"]):
            raise AssertionError(f"client shed: {r.name} off anomaly()")
    return {"chunks": chunks, "posts": admitted + shed, "shed": shed, "retries": budget["retries_allowed"],
            "retries_denied": budget["retries_denied"], "budget_requests": budget["requests"],
            "min_retry_after_s": min(h for h, _ in waits), "min_sleep_s": round(min(d for _, d in waits), 4),
            "targets_ok": len(ok), "targets": len(targets), "wall_s": round(wall, 4)}


def client_hedging(pool, per_model, names, first, reference) -> dict:
    """The two servers as replicas, a hedge after 1 ms: hedges and wins
    counted, every target within its band of the unhedged run's."""
    c, results, wall = client_run("hedge", base_url=pool.url, replica_urls=[pool.url, per_model.url], hedge=True,
                                  hedge_delay_init_s=0.001, transport="tcp", use_tensor=True)
    frames = hold_client_frames(results, reference, "hedge")
    bitwise = sum(np.array_equal(frames[n].values, first[n].values) for n in names)
    stats = dict(c._hedge_stats)
    if stats["hedges"] <= 0:
        raise AssertionError(f"client hedge: {stats}")
    return {"hedges": stats["hedges"], "hedge_wins": stats["hedge_wins"], "targets_bitwise_unhedged": bitwise,
            "wall_s": round(wall, 4)}


def client_phase(card: str):
    """The bulk client on the card's serving path: config 1's width,
    CLIENT_DENSE dense and CLIENT_LSTM ``lstm_hourglass`` detectors with
    ``RandomDataset`` metadata, banked behind a pool with a Unix socket and
    the ring (K2, K3) and per model on a ``GORDO_SERVER_BANK=0`` server
    (K1, K3); ``Client.predict`` of every target over CLIENT_RANGE in
    chunks of CLIENT_BATCH rows over each rung, a shed tenant and a hedged
    run."""
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    rng = np.random.default_rng(18)
    names = [f"client-dense-{i:02d}" for i in range(CLIENT_DENSE)] + [f"client-lstm-{i}" for i in range(CLIENT_LSTM)]
    paths = {name: os.path.join(CLIENT_DIR, name) for name in names}
    for name in names:
        entry = (random_lstm_entry(name, "LSTMAutoEncoder", rng) if "lstm" in name
                 else random_entry(name, 10, rng))
        serializer.dump(entry, paths[name], metadata={"name": name, "dataset": CLIENT_DATASET})
    before = launches()
    reference = client_reference(CLIENT_DATASET, CLIENT_RANGE, CLIENT_BATCH, paths)
    reference_launches = launched(before)
    score.reset_launch_counts()  # the phase's counts are the served runs' alone
    seq_scan.reset_launch_counts()
    rows = len(names) * CLIENT_ROWS
    uds_dir = CLIENT_DIR if len(os.path.join(CLIENT_DIR, "c.sock").encode()) < 100 else tempfile.mkdtemp(prefix="gc")
    summary = {}
    with env_set(CLIENT_ENV):
        pool = run_server(CLIENT_DIR, host="127.0.0.1", port=0, background=True,
                          uds_path=os.path.join(uds_dir, "c.sock"), shm_ring=f"gordo-client-{os.getpid()}")
    try:
        with env_set({"GORDO_SERVER_BANK": "0"}):
            per_model = run_server(CLIENT_DIR, host="127.0.0.1", port=0, background=True)
        try:
            if sorted(pool.app.bank._index) != sorted(names) or per_model.app.bank is not None:
                raise AssertionError(f"client: banked {sorted(pool.app.bank._index)}")
            if pool.app._warmup is not None:
                pool.app._warmup.join()
            summary["rungs"], first = client_bulk(pool, per_model, names, reference, rows)
            summary["shed"] = client_shedding(pool, names[:CLIENT_DENSE], reference)
            summary["hedge"] = client_hedging(pool, per_model, names, first, reference)
        finally:
            per_model.close()
    finally:
        pool.close()
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    if uds_dir != CLIENT_DIR:
        shutil.rmtree(uds_dir, ignore_errors=True)
    total = launches()
    phase("client", targets=len(names), rows_per_run=rows, chunk_rows=CLIENT_BATCH,
          rungs=json.dumps(summary["rungs"]), shed=json.dumps(summary["shed"]), hedge=json.dumps(summary["hedge"]),
          reference_launches=json.dumps(reference_launches),
          phase_launches=json.dumps(total),
          bands=json.dumps(CLIENT_BANDS), card=json.dumps(card))
    return summary


# ------------------------------------------------------------------ #
# resilience: checkpoint and resume, heartbeats, build traces, faults
# ------------------------------------------------------------------ #

RES_DIR = os.path.join(ROOT, "build", "chip_smoke_resilience")
RES_DENSE = dict(kind="feedforward_hourglass", epochs=6, batch_size=128, validation_split=0.1,
                 early_stopping_patience=2)
RES_DENSE_MEMBERS = 256
RES_LSTM = dict(model_type="LSTMAutoEncoder", epochs=3, **SEQ_CONFIG)  # epochs cut from 4 (the smoke's wall)
RES_LSTM_MEMBERS = 16
RES_COST_DENSE_MEMBERS = 256  # the save legs' dense fleet, cut from 1,024, then 512 (the smoke's wall)
RES_COST_LSTM_MEMBERS = 64  # cut from 256, then 128 (the smoke's wall)
RES_COST_LSTM_EPOCHS = 2  # cut from 3 (the smoke's wall)
RES_KILL_EPOCH = 2  # the CLI build is SIGKILLed once its heartbeat is training at this epoch or later
RES_GANG = dict(lstm=4, dense=8, lstm_epochs=4, dense_epochs=4)  # lstm_epochs cut from 5
RES_COST_ROUNDS = 3  # interleaved score_many rounds (real, stub, stub, real); cut from 5
RES_COST_CALLS = 50  # score_many calls a round


class Preempted(Exception):
    pass


def kill_after(n_syncs: int):
    calls = {"n": 0}

    def cb(info):
        calls["n"] += 1
        if calls["n"] >= n_syncs:
            raise Preempted(f"preempted after epoch {info['epoch']}")

    return cb


@contextlib.contextmanager
def counted(total: dict):
    """The launch counts from 0 on entry, read on exit into the yielded dict
    and added to ``total``: a phase sums the segments it counts and leaves
    out what runs between them (its references)."""
    score.reset_launch_counts()
    seq_scan.reset_launch_counts()
    got = {}
    yield got
    got.update(score.launch_counts)
    got.update(seq_scan.launch_counts)
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def fleet_diff(a: dict, b: dict):
    """The largest difference between two fits' parameters, histories,
    scalers and thresholds (inf where a history's length, a shape or a
    NaN differs), and whether every array is within TRAIN_RTOL/TRAIN_ATOL
    of its counterpart."""
    worst, close = 0.0, True
    for name in a:
        x, y = a[name], b[name]
        if {k: len(v) for k, v in x.history.items()} != {k: len(v) for k, v in y.history.items()}:
            return float("inf"), False
        pairs = [(x.params[k], y.params[k]) for k in x.params]
        pairs += [(x.history[k], y.history[k]) for k in x.history]
        pairs += list(zip(x.scaler, y.scaler)) + list(zip(x.error_scaler, y.error_scaler))
        pairs += [(x.feature_thresholds, y.feature_thresholds), (x.total_threshold, y.total_threshold)]
        for p, q in pairs:
            p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
            if p.shape != q.shape:
                return float("inf"), False
            if p.size:
                d = float(np.abs(p - q).max())
                worst = max(worst, d if np.isfinite(d) else float("inf"))
                close = close and bool(np.allclose(p, q, rtol=TRAIN_RTOL, atol=TRAIN_ATOL))
    return worst, close


def resilience_preemption(total: dict) -> dict:
    """(a) Each fleet killed by its epoch callback and resumed, held against
    an uninterrupted fit: bitwise where two uninterrupted fits are, else
    each array within TRAIN_RTOL/TRAIN_ATOL. The killed and resumed fits'
    launches go to ``total``."""
    out = {}
    for fam, n, config, kill_at in (("dense", RES_DENSE_MEMBERS, RES_DENSE, 3),
                                    ("lstm", RES_LSTM_MEMBERS, RES_LSTM, 2)):
        members = synth_fleet(n, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"], seed=19)
        ckdir = os.path.join(RES_DIR, f"preempt-{fam}")
        t = time.perf_counter()
        ref = FleetTrainer(**config).fit(members)
        again = FleetTrainer(**config).fit(members)
        fit_s = (time.perf_counter() - t) / 2
        with counted(total):
            try:
                FleetTrainer(checkpoint_dir=ckdir, epoch_callback=kill_after(kill_at), **config).fit(members)
            except Preempted:
                pass
            else:
                raise AssertionError(f"resilience {fam}: the fit was not preempted")
        if not os.listdir(ckdir):
            raise AssertionError(f"resilience {fam}: no checkpoint survived the preemption")
        ran = []
        t = time.perf_counter()
        with counted(total):
            resumed = FleetTrainer(checkpoint_dir=ckdir, epoch_callback=lambda i: ran.append(int(i["epoch"])),
                                   **config).fit(members)
        resume_s = time.perf_counter() - t
        first = kill_at - 1  # the kill's epoch: the save before it committed
        if not ran or ran != list(range(first, first + len(ran))):
            raise AssertionError(f"resilience {fam}: the resume ran epochs {ran}, not from {first}")
        uninterrupted, _ = fleet_diff(ref, again)
        diff, close = fleet_diff(ref, resumed)
        if uninterrupted == 0.0:
            band = "bitwise"
            if diff != 0.0:
                raise AssertionError(f"resilience {fam}: the resumed fit is {diff} off the uninterrupted one, "
                                     "which two uninterrupted fits are bitwise")
        else:
            band = f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}"
            if not close:
                raise AssertionError(f"resilience {fam}: the resumed fit is {diff} off, outside {band}")
        stopped = sum(len(m.history["loss"]) < config["epochs"] for m in ref.values())
        out[fam] = {"members": n, "epochs": config["epochs"], "resumed_epochs": ran,
                    "uninterrupted_max_diff": uninterrupted, "resumed_max_diff": diff, "band": band,
                    "early_stopped": stopped, "fit_s": round(fit_s, 4), "resume_s": round(resume_s, 4),
                    "left": os.listdir(ckdir)}
        if out[fam]["left"]:
            raise AssertionError(f"resilience {fam}: the finished fit left {out[fam]['left']}")
    return out


def resilience_cost(total: dict) -> dict:
    """(b) Steady epoch seconds with checkpoint_every=1 against none, in the
    order none, every, every, none, with the checkpoint spans' seconds, the
    median of each piece of a span (the generator states stacked, the wait
    for the save before, its commit, the copy to the host, the histories'
    deep copy) and of the writer's (the archive, both digests), and the
    bytes of a save."""
    from gordo_components_torch.observability.tracing import Trace, use_trace

    out = {}
    for fam, members, config in (
            ("dense", synth_fleet(RES_COST_DENSE_MEMBERS, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"]),
             FLEET_CONFIG),
            ("lstm", synth_fleet(RES_COST_LSTM_MEMBERS, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"]),
             dict(model_type="LSTMAutoEncoder", epochs=RES_COST_LSTM_EPOCHS, **SEQ_CONFIG))):
        steady = {"none": [], "every": []}
        spans, saved = [], []
        for side in ("none", "every", "every", "none"):
            kw = {}
            holder = {}
            if side == "every":
                trainer_box = {}

                def cb(info, box=trainer_box):
                    holder["ck"] = box["t"]._active_ckpt

                kw = dict(checkpoint_dir=os.path.join(RES_DIR, f"cost-{fam}"), checkpoint_every=1, epoch_callback=cb)
            trainer = FleetTrainer(**config, **kw)
            if side == "every":
                trainer_box["t"] = trainer
            trace = Trace(None, "resilience-cost")
            with counted(total), use_trace(trace):
                trainer.fit(members)
            epochs = trainer.last_stats["buckets"][0]["epoch_seconds"]
            steady[side].append(statistics.median(epochs[1:]))
            if side == "every":
                spans += [s for s in trace.spans if s.name == "checkpoint"]
                saved.append(holder["ck"].last_save_bytes)
        none, every = statistics.median(steady["none"]), statistics.median(steady["every"])
        if len(spans) != 2 * (config["epochs"] - 1) or min(saved) <= 0:
            raise AssertionError(f"resilience cost {fam}: {len(spans)} checkpoint spans, saves of {saved} bytes")
        pieces = {}
        for span in spans:
            for k, v in span.attributes.items():
                if k.endswith("_s"):
                    pieces.setdefault(k[:-2], []).append(v * 1e3)
        span_ms = [span.duration_s * 1e3 for span in spans]
        out[fam] = {"members": len(members), "epochs": config["epochs"],
                    "steady_epoch_s": steady, "median_epoch_s_none": none, "median_epoch_s_every": every,
                    "rise_share": every / none - 1.0, "rise_ms": (every - none) * 1e3,
                    "checkpoint_span_ms_median": statistics.median(span_ms), "checkpoint_span_ms_max": max(span_ms),
                    "span_pieces_ms_median": {k: statistics.median(v) for k, v in pieces.items()},
                    "span_pieces_ms_max": {k: max(v) for k, v in pieces.items()},
                    "save_bytes": int(max(saved))}
    return out


def res_dataset(name: str) -> dict:
    """A RandomDataset of 10 days at 10 min: 1,440 rows of 10 tags."""
    return dict(dataset(name), train_end_date="2020-01-11T00:00:00Z")


def gang_machines() -> list:
    """The killed gang: RES_GANG lstm_hourglass machines (lookback 32) first,
    so the kill lands in their bucket, then the dense ones, 1,440 rows of 10
    tags each."""
    lstm = detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=LOOKBACK,
                             epochs=RES_GANG["lstm_epochs"], batch_size=128)
    dense = detector_pipeline("AutoEncoder", kind="feedforward_hourglass", epochs=RES_GANG["dense_epochs"],
                              batch_size=128)
    out = []
    for i in range(RES_GANG["lstm"]):
        out.append({"name": f"gang-lstm-{i}", "dataset": res_dataset(f"gang-lstm-{i}"), "model": lstm})
    for i in range(RES_GANG["dense"]):
        out.append({"name": f"gang-dense-{i}", "dataset": res_dataset(f"gang-dense-{i}"), "model": dense})
    return out


def resilience_kill(runs: dict) -> dict:
    """(c) build-fleet with a checkpoint directory, a state directory and a
    gang id, SIGKILLed once its heartbeat reads training at epoch >=
    RES_KILL_EPOCH, then run again; checkpoint-prune; run-server over what
    the second run built, each machine held against its ``anomaly()``
    (computed in this process before the server starts: the references,
    returned for the faults' servers too, launch nothing counted)."""
    from gordo_components_torch.workflow import read_gang_states

    machines = gang_machines()
    payload = os.path.join(RES_DIR, "gang.json")
    with open(payload, "w") as f:
        json.dump({"machines": machines}, f)
    out_dir, ckdir, state_dir = (os.path.join(RES_DIR, d) for d in ("gang", "ck", "state"))
    args = ["build-fleet", "--machines-file", payload, "--output-dir", out_dir, "--checkpoint-dir", ckdir,
            "--state-dir", state_dir, "--gang-id", "smoke-gang"]
    log = open(os.path.join(RES_DIR, "killed.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli_command("killed_build", args, RES_DIR), cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    seen = None
    try:
        while seen is None:
            if proc.poll() is not None:
                raise AssertionError(f"resilience: the gang build ended ({proc.returncode}) before the kill")
            if time.perf_counter() - t0 > CLI_TIMEOUT_S:
                raise AssertionError("resilience: the gang build never reached the kill epoch")
            for s in read_gang_states(state_dir):
                if s.get("phase") == "training" and s.get("epoch", -1) >= RES_KILL_EPOCH:
                    seen = s
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    kill_s = time.perf_counter() - t0
    committed = [(k, e) for k in os.listdir(ckdir) for e in os.listdir(os.path.join(ckdir, k))
                 if os.path.exists(os.path.join(ckdir, k, e, "host.json"))]
    if not committed:
        raise AssertionError(f"resilience: no committed checkpoint after the kill at {seen}")
    t1 = time.perf_counter()
    proc = cli("resumed_build", args, counts_dir=RES_DIR)
    resume_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"resilience: the resumed build exited {proc.returncode}: {proc.stderr[-2000:]}")
    runs["resumed_build"] = cli_counts("resumed_build", RES_DIR)
    manifest = json.loads(proc.stdout)
    if sorted(manifest["built"]) != sorted(m["name"] for m in machines) or manifest["failed"]:
        raise AssertionError(f"resilience: the resumed build's manifest {manifest}")
    (state,) = read_gang_states(state_dir)
    if state["phase"] != "done" or state["gang_id"] != "smoke-gang" or os.listdir(ckdir):
        raise AssertionError(f"resilience: heartbeat {state}, checkpoints left {os.listdir(ckdir)}")
    with open(os.path.join(out_dir, "build_trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    # the killed bucket: the LSTM group's (the dense group's label may be the same)
    killed_label = f"fit:f{seen['bucket'][0]}x{seen['bucket'][1]}"
    fits = {f"{e['name']} ({e['args']['members']} members)": e["args"]["epochs"] for e in spans
            if e["name"].startswith("fit:")}
    killed = fits.get(f"{killed_label} ({RES_GANG['lstm']} members)")
    if killed is None or killed >= RES_GANG["lstm_epochs"] - seen["epoch"] + 1:
        raise AssertionError(f"resilience: the killed bucket {killed_label} ran {fits} epochs after the resume")
    stale = os.path.join(ckdir, "ab" * 12, "0")
    os.makedirs(stale)
    old = time.time() - 30 * 86400
    os.utime(os.path.dirname(stale), (old, old))
    # in this process: the command moves no tensor
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli_main(["checkpoint-prune", "--checkpoint-dir", ckdir, "--older-than-days", "7"])
    if rc != 0 or printed.getvalue().strip() != "Pruned 1 stale checkpoint(s)" or os.listdir(ckdir):
        raise AssertionError(f"resilience: checkpoint-prune printed {printed.getvalue()!r} ({rc})")

    refs = {}
    for m in machines:
        X = get_dataset(m["dataset"]).get_data()[0].values
        refs[m["name"]] = X, serializer.load(os.path.join(out_dir, m["name"])).anomaly(X)
    port = free_port()
    log = open(os.path.join(RES_DIR, "server.log"), "w")
    t2 = time.perf_counter()
    server = subprocess.Popen(cli_command("run_server", ["run-server", "--model-dir", out_dir, "--host", "127.0.0.1",
                                                         "--port", str(port)], RES_DIR),
                              cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}/gordo/v0/smoke"
        status, models = wait_for_models(base, server, t2)
        if status != 200 or models["models"] != sorted(m["name"] for m in machines):
            raise AssertionError(f"resilience run-server /models answered {status}: {models}")
        for m in machines:
            X, want = refs[m["name"]]
            status, body = http_json(f"{base}/{m['name']}/anomaly/prediction", {"X": X.tolist()})
            if status != 200:
                raise AssertionError(f"resilience run-server: {m['name']} answered {status}: {body}")
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if "lstm" in m["name"] else {}
            check_arrays(response_arrays(body, m["dataset"]["tag_list"]), want, f"resilience {m['name']}", **band)
    finally:
        stop_server(server)
        log.close()
    if server.returncode != 0:
        raise AssertionError(f"resilience run-server exited {server.returncode} on SIGTERM")
    runs["run_server"] = cli_counts("run_server", RES_DIR)
    return {"killed_at": {k: seen[k] for k in ("phase", "epoch", "bucket")}, "kill_s": round(kill_s, 3),
            "committed_at_kill": [e for _, e in committed], "resume_s": round(resume_s, 3),
            "fit_epochs_after_resume": fits, "heartbeat": state["phase"], "pruned": 1, "machines": len(machines),
            "out_dir": out_dir, "refs": refs}


def events_of(base: str, site: str) -> list:
    status, body = http_json(f"{base}/events?type=fault.fired")
    if status != 200:
        raise AssertionError(f"resilience: /events answered {status}")
    return [e for e in body["events"] if e["attrs"].get("site") == site]


def resilience_faults(out_dir: str, refs: dict, total: dict) -> dict:
    """(d) The fault points on the card: a retried group, a bank whose
    finalize fails (members per model: K1), a scoring fault quarantining to
    410, a reset connection the client retries through, each fault.fired in
    /events; the disarmed points' cost in score_many. ``refs``: each gang
    machine's rows and ``anomaly()``; the builds' and servers' launches go
    to ``total``, and the per-model POSTs' K1 must cover the members sent
    per model."""
    from gordo_components_torch import resilience
    from gordo_components_torch.server import bank as bank_mod

    out = {}
    machines = {m["name"]: m for m in gang_machines()}
    try:
        resilience.configure_from_env("fleet_build.group=error,times=1")
        dense = [dict(machines[f"gang-dense-{i}"], name=f"retry-{i}") for i in range(2)]
        with counted(total):
            report = build_fleet(dense, os.path.join(RES_DIR, "retry"))
        if sorted(report) != ["retry-0", "retry-1"] or report.group_retries != 1:
            raise AssertionError(f"resilience: a retried group built {sorted(report)}, {report.group_retries} retries")
        out["group_retries"] = report.group_retries
        resilience.reset()

        resilience.arm("bank.finalize", times=1)
        with counted(total):
            server = run_server(out_dir, host="127.0.0.1", port=0, background=True)
        try:
            base = server.url + "/gordo/v0/smoke"
            health = http_json(base + "/healthz")[1]
            fallback = sorted(http_json(base + "/models")[1]["bank"]["fallback"])
            # the first bucket built failed: its members, and only they, per model
            if (health["status"] != "degraded" or len(health["bank_finalize_failures"]) != 1
                    or not fallback or len(fallback) == len(machines)):
                raise AssertionError(f"resilience: finalize fault gave {health['status']}, per model {fallback}")
            answers = {}
            with counted(total) as served:
                for name in machines:
                    answers[name] = http_json(f"{base}/{name}/anomaly/prediction", {"X": refs[name][0].tolist()})
            for name, (status, body) in answers.items():
                if status != 200:
                    raise AssertionError(f"resilience per-model {name} answered {status}: {body}")
                band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if "lstm" in name else {}
                check_arrays(response_arrays(body, machines[name]["dataset"]["tag_list"]), refs[name][1],
                             f"resilience per-model {name}", **band)
            if served["fused_anomaly_score"] < len(fallback):
                raise AssertionError(f"resilience: the {len(fallback)} per-model POSTs launched "
                                     f"{served['fused_anomaly_score']} K1")
            out["finalize"] = {"healthz": health["status"], "per_model": fallback, "posts": len(machines),
                               "served_launches": served, "fault_fired": len(events_of(base, "bank.finalize"))}
            if out["finalize"]["fault_fired"] != 1:
                raise AssertionError(f"resilience: finalize fault.fired {out['finalize']}")
        finally:
            server.close()
        resilience.reset()

        X = refs["gang-dense-0"][0][:64]
        with counted(total):
            server = run_server(out_dir, host="127.0.0.1", port=0, background=True, quarantine_threshold=3)
        try:
            base = server.url + "/gordo/v0/smoke"
            resilience.arm("bank.score")
            with counted(total):
                statuses = [http_json(f"{base}/gang-dense-0/prediction", {"X": X.tolist()})[0] for _ in range(4)]
            resilience.reset()
            health = http_json(base + "/healthz")[1]
            if statuses != [400, 400, 400, 410] or "gang-dense-0" not in health["quarantined"]:
                raise AssertionError(f"resilience: bank.score gave {statuses}, healthz {health['status']}")
            out["score"] = {"statuses": statuses, "healthz": health["status"],
                            "fault_fired": len(events_of(base, "bank.score"))}
        finally:
            server.close()

        client_dir = os.path.join(RES_DIR, "client")
        rng = np.random.default_rng(19)
        names = [f"res-client-{i}" for i in range(4)]
        for name in names:
            serializer.dump(random_entry(name, 10, rng), os.path.join(client_dir, name),
                            metadata={"name": name, "dataset": CLIENT_DATASET})
        with counted(total):
            server = run_server(client_dir, host="127.0.0.1", port=0, background=True)
        try:
            resilience.configure_from_env("server.connection=reset,times=1")
            c = Client("smoke", base_url=server.url, batch_size=CLIENT_BATCH, transport="tcp", parallelism=1)
            with counted(total):
                results = c.predict(*CLIENT_RANGE)
            bad = [r.name for r in results if not r.ok]
            fired = resilience.fault_stats()["server.connection"]["fired"]
            resilience.reset()
            if bad or fired != 1:
                raise AssertionError(f"resilience: a reset connection left {bad} failed (fired {fired})")
            out["reset"] = {"targets_ok": len(results), "fired": fired,
                            "client_retries": c.retry_budget.snapshot()["retries_allowed"],
                            "fault_fired": len(events_of(server.url + "/gordo/v0/smoke", "server.connection"))}
        finally:
            server.close()
        for key in ("score", "reset"):
            if out[key]["fault_fired"] < 1:
                raise AssertionError(f"resilience: /events lists no fault.fired for {key}: {out[key]}")
    finally:
        resilience.reset()
    with counted(total):
        out["disarmed_cost"] = disarmed_cost(bank_mod)
    return out


class NoopPoint:
    """A fault point's stand-in that does nothing."""

    def fire(self) -> None:
        pass


def disarmed_cost(bank_mod) -> dict:
    """Interleaved score_many rounds with the bank's disarmed ``bank.score``
    point against a no-op stub: each side's median call ms (a finding; no
    limit)."""
    rng = np.random.default_rng(20)
    entries = [random_entry(f"cost-{i}", 10, rng) for i in range(64)]
    bank = ModelBank.from_entries(entries, registry=False)
    requests = [(e.name, rng.standard_normal((64, 10)).astype(np.float32), None) for e in entries]
    real = bank_mod._FP_SCORE
    times = {"disarmed": [], "stub": []}
    try:
        bank.score_many(requests)
        for _ in range(RES_COST_ROUNDS):
            for side in ("disarmed", "stub", "stub", "disarmed"):
                bank_mod._FP_SCORE = real if side == "disarmed" else NoopPoint()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(RES_COST_CALLS):
                    bank.score_many(requests)
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t) / RES_COST_CALLS * 1e3)
    finally:
        bank_mod._FP_SCORE = real
    a, b = statistics.median(times["disarmed"]), statistics.median(times["stub"])
    return {"requests": len(requests), "call_ms_disarmed": round(a, 5), "call_ms_stub": round(b, 5),
            "delta_share": round(a / b - 1.0, 5), "rounds": RES_COST_ROUNDS, "calls": RES_COST_CALLS}


def resilience_phase(card: str):
    """Checkpoint and resume, heartbeats, build traces and fault points on
    the card at config 1's width: (a) dense and LSTM fleets preempted and
    resumed in process; (b) what checkpoints cost an epoch; (c) a CLI gang
    build SIGKILLed and resumed, pruned, and served (K2, K3); (d) faults
    through the builder and the server (K1 per model). Returns the phase's
    launch counts: this process's counted segments (the fits, builds,
    servers and the cost loop; no reference) and the counted CLI runs'."""
    shutil.rmtree(RES_DIR, ignore_errors=True)
    os.makedirs(RES_DIR)
    here = {}
    walls = {}
    t = time.perf_counter()
    preempt = resilience_preemption(here)
    walls["preempt"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    cost = resilience_cost(here)
    walls["cost"] = round(time.perf_counter() - t, 1)
    runs = {}
    t = time.perf_counter()
    kill = resilience_kill(runs)
    walls["kill"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    faults = resilience_faults(kill.pop("out_dir"), kill.pop("refs"), here)
    walls["faults"] = round(time.perf_counter() - t, 1)
    shutil.rmtree(RES_DIR, ignore_errors=True)
    if runs["run_server"]["banked_anomaly_score"] <= 0 or runs["run_server"]["lstm_layer"] <= 0:
        raise AssertionError(f"resilience run-server launched no K2 or K3: {runs}")
    phase("resilience", preempt=json.dumps(preempt), cost=json.dumps(cost), kill=json.dumps(kill),
          faults=json.dumps(faults), walls_s=json.dumps(walls), in_process_launches=json.dumps(here),
          launches_by_run=json.dumps(runs), card=json.dumps(card))
    return {k: here[k] + sum(c.get(k, 0) for c in runs.values()) for k in here}



# ------------------------------------------------------------------ #
# phases: the low-precision bank and the streaming plane
# ------------------------------------------------------------------ #

QUANT_DTYPES = ("float32", "bfloat16", "int8")
QUANT_FAMILIES = {"dense": 10_000, "lstm": 1_000, "lstm_bf16": 1_000}  # members a bank
QUANT_RTOL, QUANT_ATOL = 0.02, 0.05  # tests/test_bank_quantized.py's band against the fp32 bank
QUANT_LOOP = dict(clients=64, requests=4)  # the bank phase's closed loop, max_batch 64


def quantized_entries(family: str):
    rng = np.random.default_rng({"dense": 21, "lstm": 22, "lstm_bf16": 23}[family])
    n = QUANT_FAMILIES[family]
    if family == "dense":
        return [random_entry(f"q{i:05d}", 10, rng) for i in range(n)]
    entries = [random_lstm_entry(f"ql{i:05d}", "LSTMAutoEncoder", rng) for i in range(n)]
    if family == "lstm_bf16":
        entries = [dataclasses.replace(e, compute_dtype=BF16) for e in entries]
    return entries


def quantized_bank(family: str, entries, bank_dtype: str, names, X):
    """Build ``entries`` at ``bank_dtype`` storage and drive the closed loop
    through the engine: (readings, {(c, r): result})."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bank = ModelBank.from_entries(entries, registry=False, bank_dtype=bank_dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated()
    cap = bank.capacity_stats()
    if cap["quantize_fallbacks"]:
        raise AssertionError(f"quantized {family} {bank_dtype}: fallbacks {cap['quantize_fallbacks']}")
    want = {"float32": "bfloat16" if family == "lstm_bf16" else "float32"}.get(bank_dtype, bank_dtype)
    if set(cap["weight_bytes_by_dtype"]) != {want}:
        raise AssertionError(f"quantized {family} {bank_dtype}: stored as {cap['weight_bytes_by_dtype']}")
    gc.collect()
    engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
    engine.start()
    try:
        engine.score_blocking(names[0][0], X[0, 0])  # the allocator's warm-up
        before = dict(engine.stats)
        launches_before = dict(score.launch_counts, **seq_scan.launch_counts)
        lat, results, wall = closed_loop(engine, names, X, f"quantized {family} {bank_dtype}")
        after = dict(score.launch_counts, **seq_scan.launch_counts)
        batches = max(engine.stats["batches"] - before["batches"], 1)
    finally:
        engine.stop()
    del bank, engine
    lat_ms = np.asarray(lat) * 1e3
    n_out = X.shape[2] - entries[0].offset
    launches = {k: after[k] - launches_before[k] for k in after}
    return {
        "build_s": round(build_s, 3), "memory_allocated": mem, "memory_allocated_delta": mem - mem0,
        "weight_bytes": cap["weight_bytes"], "fp32_bytes": cap["fp32_bytes"],
        "capacity_ratio": cap["capacity_ratio"], "models_per_gb": cap["models_per_gb"],
        "bytes_per_member": cap["bytes_per_member"],
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 4), "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
        "rows_per_s": round(len(results) * n_out / wall, 1), "batches": batches,
        "launches": {"K2": launches["banked_anomaly_score"], "K3": launches["lstm_layer"],
                     "K3_bf16": launches["lstm_layer_bf16"]},
    }, results


def quantized_phase(card: str):
    """The low-precision bank at config 1's and config 2's widths: a
    10,000-member ``feedforward_hourglass`` bank, a 1,000-member
    ``lstm_hourglass`` bank (lookback 32) and the same LSTM bank computing
    in bfloat16, each at float32, bfloat16 and int8 storage, 10 tags, with
    the bank phase's closed loop (64 clients x 4 requests, ``max_batch``
    64). Each bank's bytes, capacity ratio, members a GiB,
    ``memory_allocated`` after its build, p50, p99 and rows/s, launches,
    and its largest deviation from the float32-storage bank on the same
    requests (within QUANT_RTOL/QUANT_ATOL, every array); no quantization
    may fall back. The bf16-compute bank at int8 storage puts K3-bf16 on
    the path, dequantized to float32 and then to bfloat16."""
    n_clients, n_requests = QUANT_LOOP["clients"], QUANT_LOOP["requests"]
    summary = {}
    for family in QUANT_FAMILIES:
        entries = quantized_entries(family)
        rng = np.random.default_rng(31)
        n_rows = 64 if family == "dense" else 128
        X = rng.random((n_clients, n_requests, n_rows, 10)).astype(np.float32)
        names = [[entries[int(j)].name for j in rng.integers(0, len(entries), n_requests)]
                 for _ in range(n_clients)]
        base = None
        dtypes = ("float32", "int8") if family == "lstm_bf16" else QUANT_DTYPES
        for bank_dtype in dtypes:
            readings, results = quantized_bank(family, entries, bank_dtype, names, X)
            for res in results.values():
                if not all(np.all(np.isfinite(a)) for a in res.to_arrays().values()):
                    raise AssertionError(f"quantized {family} {bank_dtype}: non-finite scores")
            if base is None:
                base = results
            else:
                err, excess = 0.0, 0.0
                for key, res in results.items():
                    got, want = res.to_arrays(), base[key].to_arrays()
                    for k, w in want.items():
                        d = np.abs(got[k] - w)
                        err = max(err, float(d.max()))
                        excess = max(excess, float((d - QUANT_ATOL - QUANT_RTOL * np.abs(w)).max()))
                readings["max_abs_dev_vs_fp32"] = err
                if excess > 0:
                    raise AssertionError(f"quantized {family} {bank_dtype}: {err} off the fp32 bank, "
                                         f"outside rtol={QUANT_RTOL} atol={QUANT_ATOL}")
            summary[f"{family}.{bank_dtype}"] = readings
            phase("quantized", family=family, members=len(entries), bank_dtype=bank_dtype,
                  compute_dtype=entries[0].compute_dtype,
                  **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in readings.items()},
                  card=json.dumps(card))
        del entries, base
    for family in ("lstm", "lstm_bf16"):
        k3 = "K3_bf16" if family == "lstm_bf16" else "K3"
        if any(summary[f"{family}.{d}"]["launches"][k3] <= 0 for d in ("float32", "int8")):
            raise AssertionError(f"quantized {family}: {k3} was not launched")
    return summary


STREAM_DIR = os.path.join(ROOT, "build", "chip_smoke_stream")
STREAM_DENSE, STREAM_LSTM = 16, 4  # config 1's dense detectors and lstm_hourglass ones (lookback 32), 10 tags
STREAM_TAGS = [f"tag-{i}" for i in range(10)]
STREAM_TRAIN_ROWS, STREAM_EPOCHS = 240, 3  # tests/test_streaming.py's size
STREAM_WINDOW, STREAM_BATCH = 128, 96  # the window buffers' rows; rows a delivery
STREAM_SHIFTED = ("s-dense-01", "s-dense-07", "s-lstm-00", "s-lstm-02")
STREAM_PER_MODEL = "s-pca"  # a PCA detector: the per-model path (K1)
STREAM_ENV = {"GORDO_STREAM": "1", "GORDO_PUSH": "1", "GORDO_BANK_DTYPE": "int8",
              "GORDO_STREAM_WINDOW": str(STREAM_WINDOW), "GORDO_STREAM_MIN_ROWS": "32",
              "GORDO_REFIT_EPOCHS": "2", "GORDO_PUSH_INTERVAL_S": "0.1"}
STREAM_T_TRAIN, STREAM_T_LIVE = "2026-08-01T00:00:00Z", "2026-08-02T00:00:00Z"


def stream_models(prov, out_dir: str = STREAM_DIR, dense_n: int = STREAM_DENSE, lstm_n: int = STREAM_LSTM,
                  prefix: str = "s", per_model: bool = True):
    """Fit ``dense_n`` dense and ``lstm_n`` ``lstm_hourglass`` detectors
    (and, with ``per_model``, the PCA detector) on the card on the
    provider's healthy rows and write them under ``out_dir``; their names."""
    from gordo_components_torch.models.transformers import PCA

    shutil.rmtree(out_dir, ignore_errors=True)
    frames = {f"{prefix}-dense-{i:02d}": prov.frame(STREAM_T_TRAIN, STREAM_TRAIN_ROWS, STREAM_TAGS)
              for i in range(dense_n)}
    dense = FleetTrainer(kind="feedforward_hourglass", epochs=STREAM_EPOCHS, batch_size=64).fit(frames)
    lstm_frames = {f"{prefix}-lstm-{i:02d}": prov.frame(STREAM_T_TRAIN, STREAM_TRAIN_ROWS, STREAM_TAGS)
                   for i in range(lstm_n)}
    lstm = FleetTrainer(model_type="LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=LOOKBACK,
                        epochs=STREAM_EPOCHS, batch_size=64).fit(lstm_frames)
    for name, member in {**dense, **lstm}.items():
        serializer.dump(member.to_estimator(), os.path.join(out_dir, name))
    if not per_model:
        return sorted([*frames, *lstm_frames])
    pca = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("pca", PCA(n_components=5)),
        ("model", AutoEncoder(kind="feedforward_hourglass", epochs=STREAM_EPOCHS, batch_size=64))]))
    pca.fit(prov.frame(STREAM_T_TRAIN, STREAM_TRAIN_ROWS, STREAM_TAGS))
    serializer.dump(pca, os.path.join(out_dir, STREAM_PER_MODEL))
    return sorted([*frames, *lstm_frames, STREAM_PER_MODEL])


def stream_load(base: str, names, stop, statuses):
    """POST anomaly requests round the members until ``stop`` is set."""
    rng = np.random.default_rng(41)
    i = 0
    while not stop.is_set():
        X = rng.random((64, 10)).astype(np.float32)
        status, _ = http_json(f"{base}/{names[i % len(names)]}/anomaly/prediction", {"X": X.tolist()})
        statuses.append(status)
        i += 1


def stream_adapt(base: str, names, body: dict, what: str):
    """``POST /adapt`` under a concurrent scoring loop (4 threads):
    (answer, its wall s, the loop's statuses)."""
    stop, statuses = threading.Event(), []
    threads = [threading.Thread(target=stream_load, args=(base, names[k::4], stop, statuses)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        t0 = time.perf_counter()
        status, answer = http_json(f"{base}/adapt", body)
        wall = time.perf_counter() - t0
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
    if status != 200 or not answer.get("applied"):
        raise AssertionError(f"stream {what}: {status} {answer}")
    bad = [s for s in statuses if s != 200]
    if bad or not statuses:
        raise AssertionError(f"stream {what}: {len(bad)} answers other than 200 of {len(statuses)}")
    return answer, wall, statuses


def stream_phase(card: str):
    """The streaming plane on the card: a server over 16 dense and 4
    ``lstm_hourglass`` detectors (10 tags, lookback 32) fitted on the card
    on ``SimulatedLiveProvider``'s healthy rows, and a PCA detector scored
    per model (K1), with ``GORDO_STREAM=1``, ``GORDO_PUSH=1`` and
    ``GORDO_BANK_DTYPE=int8``. Healthy windows go in over JSON, the tensor
    wire and ``Client.ingest``; ``/drift`` flags nothing; a mean shift of 4
    in STREAM_SHIFTED's windows, and ``/drift`` flags exactly those; then
    ``/adapt`` recalibrates them and refits them, each under a concurrent
    scoring loop: a new generation each time and no answer but 200. A push
    subscriber on a dense member and one on the PCA member receive their
    scored windows. Readings: ingest rows/s, the drift sweep's seconds, the
    two adaptations' walls and ``pause_ms``, launches."""
    from gordo_components_torch.client.http import Session
    from gordo_components_torch.client.subscribe import PushSubscriber
    from gordo_components_torch.dataset.data_provider.streaming import SimulatedLiveProvider

    prov = SimulatedLiveProvider(freq="10s", noise=0.1, seed=5)
    t0 = time.perf_counter()
    names = stream_models(prov)
    fit_s = time.perf_counter() - t0
    score.reset_launch_counts()  # the phase's counts are the server's run alone, not the fits'
    seq_scan.reset_launch_counts()
    with env_set({**STREAM_ENV, "GORDO_SERVER_WARMUP": "0"}):
        server = run_server(STREAM_DIR, host="127.0.0.1", port=0, background=True)
    base = f"{server.url}/gordo/v0/smoke"
    subs = {name: PushSubscriber(server.url, "smoke", name, subscriber=f"smoke-{name}", poll_timeout_s=2.0)
            for name in ("s-dense-00", STREAM_PER_MODEL)}
    sub_stop = threading.Event()

    def subscribe():
        async def run():
            async with Session(timeout=60) as session:
                while not sub_stop.is_set():
                    for sub in subs.values():
                        await sub.poll_once(session)
        asyncio.run(run())

    sub_thread = threading.Thread(target=subscribe, daemon=True)
    try:
        app = server.app
        if app.bank.bank_dtype != "int8" or app.bank.capacity_stats()["quantize_fallbacks"]:
            raise AssertionError(f"stream: bank {app.bank.capacity_stats()}")
        sub_thread.start()
        time.sleep(0.3)
        cursor = [time.time() - 3600.0]

        def stamps(ts):
            out = np.asarray(ts) - ts[0] + cursor[0]
            cursor[0] = float(out[-1]) + 10.0
            return out

        client = Client("smoke", base_url=server.url, batch_size=STREAM_BATCH)
        rows = 0
        t_ingest = time.perf_counter()

        def deliver(i, name, start):
            ts, vals = prov.batch(start, STREAM_BATCH, STREAM_TAGS)
            ts = stamps(ts)
            if i % 3 == 0:
                status, body = http_json(f"{base}/{name}/ingest", {
                    "rows": [[None if v != v else float(v) for v in r] for r in vals.tolist()],
                    "timestamps": ts.tolist()})
            elif i % 3 == 1:
                status, body = http_json(f"{base}/{name}/ingest", raw=pack_frames(
                    [("rows", vals), ("timestamps", ts)]), content_type=TENSOR_CONTENT_TYPE)
            else:
                status, body = 200, client.ingest(name, vals, timestamps=ts.tolist())
            if status != 200 or body["accepted"] != STREAM_BATCH:
                raise AssertionError(f"stream ingest {name}: {status} {body}")
            return len(vals)

        for i, name in enumerate(names):
            rows += deliver(i, name, STREAM_T_LIVE)
        healthy_s = time.perf_counter() - t_ingest
        t = time.perf_counter()
        status, drift = http_json(f"{base}/drift?refresh=1")
        sweep_s = [time.perf_counter() - t]
        if status != 200 or drift["drifted"] != []:
            raise AssertionError(f"stream: healthy windows drifted: {drift['drifted']}")
        prov.inject(mean_shift=4.0)
        t = time.perf_counter()
        for k in range(2):  # 192 rows displace the healthy 128-row windows
            for i, name in enumerate(STREAM_SHIFTED):
                rows += deliver(i + k, name, to_ns(STREAM_T_LIVE) + (k + 1) * 3_600_000_000_000)
        shifted_s = time.perf_counter() - t
        prov.clear()
        t = time.perf_counter()
        status, drift = http_json(f"{base}/drift?refresh=1")
        sweep_s.append(time.perf_counter() - t)
        if drift["drifted"] != sorted(STREAM_SHIFTED):
            raise AssertionError(f"stream: /drift flagged {drift['drifted']}, shifted {sorted(STREAM_SHIFTED)}")
        scores = {n: m.get("drift_score") for n, m in drift["members"].items()}
        gen0 = app.generation()
        recal, recal_s, recal_statuses = stream_adapt(base, names, {}, "recalibrate")
        if recal["members"] != sorted(STREAM_SHIFTED):
            raise AssertionError(f"stream: recalibrated {recal['members']}")
        refit, refit_s, refit_statuses = stream_adapt(base, names, {"mode": "refit", "targets": list(STREAM_SHIFTED)},
                                                      "refit")
        if [recal["swap"]["generation"], refit["swap"]["generation"]] != [gen0 + 1, gen0 + 2]:
            raise AssertionError(f"stream: generations {recal['swap']} {refit['swap']} after {gen0}")
        for name in STREAM_SHIFTED:
            det = app.collection.models[name]
            if det.threshold_method_ != "incremental-refit":
                raise AssertionError(f"stream: {name} not refit ({det.threshold_method_})")
        # the pushed windows: wait for the push loop and the subscribers
        deadline = time.time() + 30
        while time.time() < deadline and not all(len(s.results) for s in subs.values()):
            time.sleep(0.1)
        if not all(len(s.results) for s in subs.values()):
            raise AssertionError(f"stream: push subscribers got {[len(s.results) for s in subs.values()]}")
        for sub in subs.values():
            for doc in sub.results:
                if doc["target"] != sub.target or len(doc["total_scaled"]) != doc["scored"]:
                    raise AssertionError(f"stream: pushed window {doc['target']}: {doc['scored']} scored")
                if not np.all(np.isfinite(doc["total_scaled"])):
                    raise AssertionError(f"stream: pushed non-finite scores for {doc['target']}")
        status, view = http_json(f"{base}/drift")
        metrics = http_raw(f"{base}/metrics")[2].decode()
        for family in ("gordo_stream_rows_total", "gordo_drift_score", "gordo_push_published_total",
                       "gordo_bank_weight_bytes", "gordo_bank_models_per_gb"):
            if family not in metrics:
                raise AssertionError(f"stream: /metrics lacks {family}")
    finally:
        sub_stop.set()
        sub_thread.join(30)
        server.close()
    readings = {
        "members": len(names), "banked": STREAM_DENSE + STREAM_LSTM, "per_model": 1,
        "fit_s": round(fit_s, 3), "ingested_rows": rows,
        "ingest_rows_per_s": round(rows / (healthy_s + shifted_s), 1),
        "drift_sweep_s": [round(s, 4) for s in sweep_s],
        "drifted": drift["drifted"], "drift_scores": json.dumps({n: scores[n] for n in sorted(scores)}),
        "recalibrate_wall_s": round(recal_s, 4), "refit_wall_s": round(refit_s, 4),
        "pause_ms": [recal["swap"]["pause_ms"], refit["swap"]["pause_ms"]],
        "generations": [recal["swap"]["generation"], refit["swap"]["generation"]],
        "requests_under_adapt": len(recal_statuses) + len(refit_statuses), "non_200_under_adapt": 0,
        "pushed": {n: len(s.results) for n, s in subs.items()},
        "push": json.dumps(view["push"]), "stats": json.dumps(view["stats"]),
        # since the reset after the fits: the server, the drift sweeps, both
        # adaptations (the refit's error pass) and their scoring loops, the push loop
        "launches": {"K1": score.launch_counts["fused_anomaly_score"],
                     "K2": score.launch_counts["banked_anomaly_score"],
                     "K3": seq_scan.launch_counts["lstm_layer"]},
    }
    if min(readings["launches"].values()) <= 0:
        raise AssertionError(f"stream: the server's run launched {readings['launches']}")
    phase("stream", **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in readings.items()},
          card=json.dumps(card))
    return readings


# ------------------------------------------------------------------ #
# gang: worker threads, the member-width cap, staging engines, profiler
# ------------------------------------------------------------------ #

GANG_DIR = os.path.join(ROOT, "build", "chip_smoke_gang")
GANG_MEMBERS = 4  # machines a gang
GANG_EPOCHS = 2  # cut from 3 (the smoke's wall)
GANG_LOOKBACKS = (10, 12, 16)  # the lstm_hourglass gangs
GANG_WIDTHS = (1, 4, 1, 4)  # GORDO_GANG_WIDTH of the four builds; the second and third are the fair pair
GANG_CAP = 256  # the member-width cap the train phase's fleet is fitted at, beside no cap
GANG_CAP_EPOCHS = 2  # cut from 3 (the smoke's wall)
GANG_TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
GANG_CAPTURES = 16  # traced POSTs of the bank group, each captured and each held to K2 and K3
GANG_PROCESS_WORKERS = 2  # the process engine's workers a group


def gang_phase_machines() -> list:
    """Six small heterogeneous gangs of GANG_MEMBERS machines (10 tags,
    1,008 rows): dense, variational, conv and lstm_hourglass at each of
    GANG_LOOKBACKS; two dense machines resample at 7 min with the median."""
    models = {
        "dense": detector_pipeline("AutoEncoder", kind="feedforward_hourglass", epochs=GANG_EPOCHS,
                                   batch_size=128),
        "vae": detector_pipeline("AutoEncoder", kind="feedforward_variational", epochs=GANG_EPOCHS,
                                 batch_size=128),
        "conv": detector_pipeline("ConvAutoEncoder", lookback_window=LOOKBACK, epochs=GANG_EPOCHS,
                                  batch_size=128),
        **{f"lstm{lb}": detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=lb,
                                          epochs=GANG_EPOCHS, batch_size=128) for lb in GANG_LOOKBACKS},
    }
    out = []
    for gang, model in models.items():
        for i in range(GANG_MEMBERS):
            name = f"gang-{gang}-{i}"
            ds = dataset(name)
            if gang == "dense" and i < 2:
                ds = dict(ds, resolution="7min", aggregation_method="median")
            out.append({"name": name, "dataset": ds, "model": model})
    return out


def gang_artifacts(out_dir: str, names) -> dict:
    """(machine, what) -> arrays: every member's parameters, scalers and
    thresholds as written."""
    out = {}
    for name in names:
        d = os.path.join(out_dir, name)
        for f in ("params.npz", "scalers.npz"):
            with np.load(os.path.join(d, f)) as z:
                out[(name, f)] = {k: z[k] for k in z.files}
        with open(os.path.join(d, "detector.json")) as f:
            thresholds = json.load(f)["thresholds"]
        out[(name, "thresholds")] = {
            "feature": np.asarray(list(thresholds["feature-thresholds"].values()), np.float64),
            "total": np.asarray([thresholds["total-anomaly-threshold"]], np.float64)}
    return out


def gang_compare(ref: dict, got: dict, bitwise_keys, what: str) -> float:
    """Hold ``got`` to ``ref``: bitwise where two width-1 builds are
    bitwise, else within the training bands; the largest difference."""
    worst = 0.0
    for key, arrays in ref.items():
        lstm = "-lstm" in key[0]
        rtol, atol = (LSTM_RTOL, LSTM_ATOL) if lstm else (TRAIN_RTOL, TRAIN_ATOL)
        if got[key].keys() != arrays.keys():
            raise AssertionError(f"gang {what}: {key} holds {sorted(got[key])}, expected {sorted(arrays)}")
        for k, want in arrays.items():
            have = got[key][k]
            if key in bitwise_keys:
                if not np.array_equal(have, want, equal_nan=True):
                    raise AssertionError(f"gang {what}: {key}/{k} differs from the width-1 build")
                continue
            worst = max(worst, float(np.abs(np.asarray(have, np.float64) - want).max()) if want.size else 0.0)
            if not np.allclose(have, want, rtol=rtol, atol=atol):
                raise AssertionError(f"gang {what}: {key}/{k} outside rtol {rtol} / atol {atol}")
    return worst


def gang_build(machines, out_dir: str, env: dict) -> tuple:
    """One build_fleet under ``env``: (report, wall seconds, fit spans)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    with env_set(env):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = build_fleet(machines, out_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if report.failed or len(report) != len(machines):
        raise AssertionError(f"gang: built {len(report)} of {len(machines)}, failed {report.failed}")
    with open(os.path.join(out_dir, "build_trace.json")) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    (root,) = [e for e in events if e.get("name") == "fleet_build" and e.get("ph") == "X"]
    if root["args"].get("gang_width") != report.gang_width:
        raise AssertionError(f"gang: build_trace.json gang_width {root['args'].get('gang_width')}, "
                             f"report {report.gang_width}")
    fits = [e for e in events if str(e.get("name", "")).startswith("fit:")]
    return report, wall, fits


def gang_builds(machines) -> dict:
    """The four builds at GANG_WIDTHS and one at width 4 with the process
    staging engine, their artifacts held together."""
    names = [m["name"] for m in machines]
    n_groups = 3 + len(GANG_LOOKBACKS)
    runs, arts = [], []
    plan = [(w, "thread") for w in GANG_WIDTHS] + [(4, "process")]
    for i, (width, mode) in enumerate(plan):
        out_dir = os.path.join(GANG_DIR, f"build-{i}")
        # each spawned worker imports this script (torch and the port):
        # GANG_PROCESS_WORKERS a group, cut from the default 4 (the smoke's wall)
        env = {"GORDO_GANG_WIDTH": str(width), "GORDO_LOAD_MODE": mode,
               **({"GORDO_LOAD_WORKERS": str(GANG_PROCESS_WORKERS)} if mode == "process" else {})}
        report, wall, fits = gang_build(machines, out_dir, env)
        if report.gang_width != min(width, n_groups):
            raise AssertionError(f"gang: width {report.gang_width} at GORDO_GANG_WIDTH={width}")
        # every group's buckets have their fit: spans, whichever thread trained them
        members = sum(int(e["args"]["members"]) for e in fits)
        if len(fits) < n_groups or members != len(machines):
            raise AssertionError(f"gang: {len(fits)} fit spans over {members} members, "
                                 f"expected >= {n_groups} over {len(machines)}")
        # the groups' own staging and training seconds, summed (their
        # metadata spreads each over its members)
        load_s = fit_s = 0.0
        for name in names:
            with open(os.path.join(out_dir, name, "metadata.json")) as f:
                model_md = json.load(f)["model"]
            load_s += model_md["data_query_duration_sec"]
            fit_s += model_md["model_training_duration_sec"]
        runs.append({"width": report.gang_width, "load_mode": mode, "wall_s": round(wall, 3),
                     "models_per_hour": round(len(machines) / wall * 3600, 1), "fit_spans": len(fits),
                     "groups_load_s": round(load_s, 3), "groups_fit_s": round(fit_s, 3)})
        arts.append(gang_artifacts(out_dir, names))
    # plan: w1, w4, w1, w4, w4 process; the width-1 builds decide bitwise
    bitwise = {k for k, v in arts[0].items()
               if all(np.array_equal(a, b, equal_nan=True) for a, b in zip(v.values(), arts[2][k].values()))}
    worst = {f"build{i}": gang_compare(arts[0], arts[i], bitwise, f"build {i}") for i in (1, 3, 4)}
    worst["build2"] = gang_compare(arts[0], arts[2], set(), "build 2")
    return {"runs": runs, "bitwise_share": round(len(bitwise) / len(arts[0]), 4), "max_abs_diff": worst,
            "fair_pair_speedup": round(runs[1]["models_per_hour"] / runs[2]["models_per_hour"], 4)}


def gang_width_cap() -> dict:
    """GORDO_FLEET_WIDTH: the auto sweep (once, then read from its cache),
    and the train phase's fleet fitted capped and uncapped, in turns."""
    from gordo_components_torch.parallel import autotune

    sweeps, cache = [], os.path.join(GANG_DIR, "fleet_width.json")
    arch = f"AutoEncoder:{FLEET_CONFIG['kind']}"

    def sweep(a):
        sweeps.append(autotune.calibrate_width(a, "cuda"))
        return sweeps[-1]

    with env_set({"GORDO_FLEET_WIDTH": "auto", "GORDO_FLEET_WIDTH_CACHE": cache}):
        autotune._process_cache.pop(f"{arch}|{autotune._device_kind('cuda')}", None)
        picked = autotune.resolve_fleet_width(arch, sweep=sweep, device="cuda")
        autotune._process_cache.clear()  # a new process: the file answers
        again = autotune.resolve_fleet_width(arch, sweep=sweep, device="cuda")
    if len(sweeps) != 1 or again != picked:
        raise AssertionError(f"gang: {len(sweeps)} sweeps, widths {picked} then {again}")
    members = synth_fleet(**FLEET_SHAPE)
    config = dict(FLEET_CONFIG, epochs=GANG_CAP_EPOCHS)
    fits = {"uncapped": [], "capped": []}
    for label in ("uncapped", "capped", "capped", "uncapped"):
        with env_set({"GORDO_FLEET_WIDTH": str(GANG_CAP) if label == "capped" else "off"}):
            trainer = FleetTrainer(**config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models = trainer.fit(members)
            wall = time.perf_counter() - t0
        losses = np.array([m.history["loss"] for m in models.values()])
        fell = float(np.mean(losses[:, -1] < losses[:, 0]))
        if fell < 0.99 or len(models) != len(members):
            raise AssertionError(f"gang: {label} fit's loss fell for a share of {fell}")
        chunks = [b["n_members"] for b in trainer.last_stats["buckets"]]
        want = [GANG_CAP] * (len(members) // GANG_CAP) if label == "capped" else [len(members)]
        if chunks != want or trainer.last_stats["width_cap"] != (GANG_CAP if label == "capped" else None):
            raise AssertionError(f"gang: {label} fit trained chunks {chunks}")
        fits[label].append({"wall_s": round(wall, 4), "models_per_hour": round(len(members) / wall * 3600, 1),
                            "loss_fell_share": fell})
    measured = sweeps[0][1]
    return {"auto_width": picked, "sweeps": len(sweeps), "sweep_members_per_s": measured,
            "members": len(members), "epochs": GANG_CAP_EPOCHS, "cap": GANG_CAP, **fits}


def trace_kernels(directory: str) -> tuple:
    """The kernel names of the Chrome trace under ``directory`` (exactly
    one), which must hold a kernel for every kernel launch it recorded
    after its lead-in (``profiling.LEAD_IN_RANGE``), and the lead-in's
    launches that came back without their kernel."""
    from gordo_components_torch.utils.profiling import LEAD_IN_LAUNCHES, LEAD_IN_RANGE

    (path,) = [p for p in os.listdir(directory) if p.endswith(".pt.trace.json")]
    with open(os.path.join(directory, path)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel"}
    (lead_in,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == LEAD_IN_RANGE]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")]
    inside = [e for e in launches if lead_in["ts"] <= e["ts"] <= lead_in["ts"] + lead_in["dur"]]
    after = [e for e in launches if e["ts"] > lead_in["ts"] + lead_in["dur"]]
    lost = [e for e in after if e["args"].get("correlation") not in kernels]
    if len(inside) < LEAD_IN_LAUNCHES or not after or lost:
        raise AssertionError(f"gang: the capture {directory} recorded {len(inside)} lead-in launches and "
                             f"{len(after)} after them, {len(lost)} of those without their kernel")
    lead_in_lost = sum(e["args"].get("correlation") not in kernels for e in inside)
    return sorted({e["name"] for e in kernels.values()}), lead_in_lost


def gang_profiles(machines) -> dict:
    """GORDO_PROFILE_DIR: one LSTM gang's fit (one epoch), then the bank
    groups of GANG_CAPTURES traced requests to the built gang; each capture
    must hold every kernel it launched, K3 in the fit's error pass, K2 and
    K3 in each group."""
    prof = os.path.join(GANG_DIR, "profiles")
    shutil.rmtree(prof, ignore_errors=True)
    lb = GANG_LOOKBACKS[0]
    model = detector_pipeline("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=lb, epochs=1,
                              batch_size=128)
    lstm = [dict(m, model=model) for m in machines if m["name"].startswith(f"gang-lstm{lb}-")]
    out_dir = os.path.join(GANG_DIR, "profiled")
    with env_set({"GORDO_PROFILE_DIR": prof}):
        gang_build(lstm, out_dir, {})
    fit_kernels, fit_lead_in_lost = trace_kernels(os.path.join(prof, f"fleet-gang-{len(lstm)}m"))
    if not any("lstm_steps" in k for k in fit_kernels):
        raise AssertionError(f"gang: the LSTM gang's capture names no K3 kernel: {fit_kernels[:20]}")
    target = lstm[0]["name"]
    X = get_dataset(lstm[0]["dataset"]).get_data()[0].values[:64]
    serve, lead_in_lost = [], []
    with env_set({"GORDO_PROFILE_DIR": prof, "GORDO_TRACE_SAMPLE": "1"}):
        server = run_server(out_dir, host="127.0.0.1", port=0, background=True)
        try:
            base = server.url + "/gordo/v0/proj"
            for i in range(GANG_CAPTURES):
                trace_id = f"{i:02x}{GANG_TRACE_ID[2:]}"
                status, _, _ = http_raw(base + f"/{target}/anomaly/prediction",
                                        json.dumps({"X": X.tolist()}).encode(),
                                        {"Content-Type": "application/json",
                                         "traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
                if status != 200:
                    raise AssertionError(f"gang: the traced POST answered {status}")
                status, answer = http_json(base + f"/traces?id={trace_id}")
                if status != 200:
                    raise AssertionError(f"gang: /traces answered {status}")
                (trace,) = answer["traces"]
                (execute,) = [s for s in trace["spans"]["children"] if s["name"] == "device_execute"]
                serve_dir = os.path.join(prof, f"serve-{trace_id}")
                if execute["attributes"].get("profile") != serve_dir:
                    raise AssertionError(f"gang: device_execute's profile is {execute['attributes'].get('profile')}")
                kernels, lost = trace_kernels(serve_dir)
                lead_in_lost.append(lost)
                if not (any("score_rows<" in k and "true>" in k for k in kernels)
                        and any("lstm_steps" in k for k in kernels)):
                    raise AssertionError(f"gang: the bank group's capture {i} names no K2 or no K3 kernel: "
                                         f"{kernels[:20]}")
                serve.append(kernels)
        finally:
            server.close()
    # the lead-in launches each capture lost: the records the profiler
    # dropped at its start
    return {"fit_trace_kernels": len(fit_kernels), "serve_trace_kernels": [len(k) for k in serve],
            "fit_lead_in_lost": fit_lead_in_lost, "serve_lead_in_lost": lead_in_lost,
            "k3_names": [k for k in fit_kernels if "lstm_steps" in k][:2],
            "k2_names": [k for k in serve[0] if "score_rows<" in k][:2]}


def gang_phase(card: str):
    """Gang worker threads (GORDO_GANG_WIDTH 1, 4, 1, 4, then 4 with the
    process staging engine), the member-width cap and the profiler."""
    shutil.rmtree(GANG_DIR, ignore_errors=True)
    machines = gang_phase_machines()
    t = time.perf_counter()
    builds = gang_builds(machines)
    builds_s = time.perf_counter() - t
    t = time.perf_counter()
    cap = gang_width_cap()
    cap_s = time.perf_counter() - t
    t = time.perf_counter()
    profiles = gang_profiles(machines)
    profiles_s = time.perf_counter() - t
    phase("gang", machines=len(machines), gangs=3 + len(GANG_LOOKBACKS), epochs=GANG_EPOCHS,
          builds=json.dumps(builds["runs"]), fair_pair_speedup=builds["fair_pair_speedup"],
          bitwise_share=builds["bitwise_share"], max_abs_diff=json.dumps(builds["max_abs_diff"]),
          width_cap=json.dumps(cap), profiles=json.dumps(profiles),
          seconds=json.dumps({"builds": round(builds_s, 1), "cap": round(cap_s, 1),
                              "profiles": round(profiles_s, 1)}), card=json.dumps(card))


REPLAY_DIR = os.path.join(ROOT, "build", "chip_smoke_replay")
REPLAY_EPOCHS = 3  # the JAX harness's train_fleet default
# every standard scenario, in the catalog's order
REPLAY_SCENARIOS = ("mean_shift", "variance_inflation", "sensor_dropout", "flatline", "late_duplicate",
                    "seasonal_cycle", "correlated_failure", "refit_fault_mid_incident")


def replay_series(registry) -> dict:
    """The ``gordo_replay_*`` samples a registry renders, by name."""
    _, samples = parse_prometheus_text(registry.render())
    return {name: value for name, _, value in samples if name.startswith("gordo_replay_")}


def replay_phase(card: str):
    """The replay harness on the card: ``default_fleet()`` (4 members, 3
    and 5 tags) trained with ``train_fleet`` on the card, then each of
    REPLAY_SCENARIOS through one ``ReplayEngine`` at the JAX defaults
    (speed 500, 24-row batches, 128-row windows), a fresh server on a
    fresh replay clock each. Every verdict must pass its scenario's
    ``judge`` whole (the 100x speed floor included) with no answer but
    200; ``refit_fault_mid_incident`` must record its rollback. A scenario
    that raises fails the phase. The counts go to 0 after the fleet's fit,
    so the phase's launches are the engine's servers' (drift sweeps and
    probes through the bank: K2)."""
    from gordo_components_torch.replay import scenarios as replay_scenarios
    from gordo_components_torch.replay.engine import ReplayEngine, train_fleet

    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    members = replay_scenarios.default_fleet()
    t = time.perf_counter()
    train_fleet(REPLAY_DIR, members, epochs=REPLAY_EPOCHS)
    train_s = time.perf_counter() - t
    score.reset_launch_counts()
    seq_scan.reset_launch_counts()
    engine = ReplayEngine(REPLAY_DIR, members)
    scenarios = {sc.name: sc for sc in replay_scenarios.standard_scenarios()}
    readings = {}
    for name in REPLAY_SCENARIOS:
        k2 = score.launch_counts["banked_anomaly_score"]
        verdict = engine.run_sync(scenarios[name])
        launched = score.launch_counts["banked_anomaly_score"] - k2
        if not verdict["passed"] or verdict["non_200"] != 0:
            raise AssertionError(f"replay {name}: {verdict['failures']} (statuses {verdict['statuses']}, "
                                 f"degradation {verdict['degradation']})")
        if name == "refit_fault_mid_incident" and verdict["rolled_back"] < 1:
            raise AssertionError(f"replay {name}: no rollback recorded ({verdict['degradation']})")
        if launched <= 0:
            raise AssertionError(f"replay {name}: the bank launched no banked_anomaly_score")
        readings[name] = {
            "wall_s": verdict["wall_seconds"], "speedup": verdict["speedup"],
            "detection_latency_s": {k: v["detection_latency_s"] for k, v in verdict["incidents"].items()},
            "flagged": verdict["ever_drifted"], "adaptation_cost_s": round(verdict["adaptation_cost_s"], 4),
            "refit_s": round(verdict["refit_s"], 4), "swap_pause_ms_max": verdict["swap_pause_ms_max"],
            "fp_before": verdict["fp_rate_before"], "fp_after": verdict["fp_rate_after"],
            "fn_after": verdict["fn_rate_after"], "adaptations": verdict["adaptations"],
            "rolled_back": verdict["rolled_back"], "generation": verdict["generation"],
            "rows": verdict["rows_total"], "duplicates": verdict["duplicate_rows_total"],
            "statuses": verdict["statuses"], "k2_launches": launched, "series": replay_series(engine.registry),
        }
        phase(f"replay.{name}", **{k: json.dumps(v) for k, v in readings[name].items()})
    if engine.totals["scenarios"] != len(REPLAY_SCENARIOS) or engine.totals["non_200"] != 0:
        raise AssertionError(f"replay: engine totals {engine.totals}")
    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    phase("replay", scenarios=len(readings), train_s=round(train_s, 3),
          walls=json.dumps({n: r["wall_s"] for n, r in readings.items()}),
          speedups=json.dumps({n: r["speedup"] for n, r in readings.items()}),
          k2_launches=score.launch_counts["banked_anomaly_score"], card=json.dumps(card))


# ------------------------------------------------------------------ #
# watchman: the fleet-health service over three one-card replicas
# ------------------------------------------------------------------ #

WATCHMAN_DIR = os.path.join(ROOT, "build", "chip_smoke_watchman")
WATCHMAN_REPLICAS = 3
WATCHMAN_DENSE, WATCHMAN_LSTM = 6, 2  # a replica: config 1's dense and config 2's lstm_hourglass detectors, 10 tags
WATCHMAN_SHIFTED = 2  # replica 0's members given a mean shift
WATCHMAN_REFRESH_S = 30.0  # the JAX default; the watchman's clock is stepped past it
WATCHMAN_ENV = {"GORDO_STREAM": "1", "GORDO_STREAM_WINDOW": str(STREAM_WINDOW), "GORDO_STREAM_MIN_ROWS": "32",
                "GORDO_HISTORY": "1", "GORDO_TRACE_SAMPLE": "1",
                # the planes' samples only on request: each replica's part of a
                # rollup is then the same as the replica's own answer a moment later
                "GORDO_HISTORY_INTERVAL_S": "3600", "GORDO_SLO_SAMPLE_S": "3600", "GORDO_HEAT_SAMPLE_S": "3600",
                "GORDO_COST_SAMPLE_S": "3600"}
WATCHMAN_SPAN = ("2020-01-01T00:00:00Z", "2020-01-02T00:00:00Z")  # 144 rows at 10 min: two chunks a member
WATCHMAN_BATCH = 72
WATCHMAN_DATASET = {"type": "RandomDataset", "tag_list": STREAM_TAGS, "resolution": "10min"}


def request_counters(text: str) -> dict:
    """``gordo_server_requests_total`` by its labels, less the ``metrics``
    kind, which each scrape moves."""
    return {tuple(sorted(labels.items())): value for name, labels, value in parse_prometheus_text(text)[1]
            if name == "gordo_server_requests_total" and labels.get("kind") != "metrics"}


def summed_counters(agg: dict) -> dict:
    return {labels: value for (name, labels), value in agg["sums"].items()
            if name == "gordo_server_requests_total" and dict(labels).get("kind") != "metrics"}


# watchman route -> (the replica's route, replica i's part of the watchman's
# body, the same part of the replica's own body)
WATCHMAN_ROLLUPS = {
    "/traces?n=5": ("/traces/slow?n=5", lambda body, i: body["replicas"][i].get("traces"),
                    lambda own, i: own.get("traces") if own.get("enabled") else None),
    "/slo": ("/slo", lambda body, i: body["replicas"][i]["worst"], lambda own, i: own.get("worst")),
    "/heat": ("/heat?top=10", lambda body, i: body["replicas"][i]["heat_enabled"],
              lambda own, i: bool(own.get("enabled"))),
    "/costs": ("/costs", lambda body, i: body["replicas"][i]["cost_enabled"], lambda own, i: bool(own.get("enabled"))),
    "/history": ("/history", lambda body, i: {k: v for k, v in body["replicas"][i].items()
                                              if k not in ("replica", "scraped")}, lambda own, i: own),
    "/events": ("/events", lambda body, i: [{k: v for k, v in e.items() if k != "replica_index"}
                                            for e in body["events"] if e.get("replica_index") == i],
                lambda own, i: [dict(e, replica=e.get("replica") or f"replica-{i}") for e in own["events"]]),
}


def watchman_replicas(names: dict) -> tuple:
    """Start each replica's ``run-server`` (counted CLI subprocesses on the
    card) and the CLI's ``run-watchman`` over replica 0, all at once, and
    wait for the replicas; (processes, base URLs, logs, the
    ``run-watchman`` process and its URL)."""
    servers, bases, logs, t0 = [], [], [], time.perf_counter()
    for r in range(WATCHMAN_REPLICAS):
        port = free_port()
        log = open(os.path.join(WATCHMAN_DIR, f"replica-{r}.log"), "w")
        servers.append(subprocess.Popen(
            cli_command(f"watchman_replica_{r}", ["run-server", "--model-dir", os.path.join(WATCHMAN_DIR, f"r{r}"),
                                                   "--host", "127.0.0.1", "--port", str(port)],
                        counts_dir=WATCHMAN_DIR),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=dict(os.environ, **WATCHMAN_ENV)))
        bases.append(f"http://127.0.0.1:{port}")
        logs.append(log)
    port = free_port()
    logs.append(open(os.path.join(WATCHMAN_DIR, "run-watchman.log"), "w"))
    cli_proc = subprocess.Popen([sys.executable, "-m", "gordo_components_torch.cli", "run-watchman", "--project",
                                 "smoke", "--server-base-url", bases[0], "--host", "127.0.0.1", "--port", str(port)],
                                cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT)
    for r, (base, server) in enumerate(zip(bases, servers)):
        status, models = wait_for_models(f"{base}/gordo/v0/smoke", server, t0)
        if status != 200 or models["models"] != names[r] or models["bank"]["banked"] != names[r]:
            raise AssertionError(f"watchman replica {r} /models answered {status}: {models}")
    return servers, bases, logs, cli_proc, f"http://127.0.0.1:{port}"


def watchman_ingest(prov, base: str, names, shifted, cursor) -> int:
    """One healthy delivery into each of ``names``, then ``shifted`` two
    deliveries of a mean shift of 4 (as the stream phase); rows sent."""
    rows = 0

    def deliver(name, start):
        ts, vals = prov.batch(start, STREAM_BATCH, STREAM_TAGS)
        ts = np.asarray(ts) - ts[0] + cursor[0]
        cursor[0] = float(ts[-1]) + 10.0
        status, body = http_json(f"{base}/gordo/v0/smoke/{name}/ingest", {
            "rows": [[None if v != v else float(v) for v in r] for r in vals.tolist()], "timestamps": ts.tolist()})
        if status != 200 or body["accepted"] != STREAM_BATCH:
            raise AssertionError(f"watchman ingest {name}: {status} {body}")
        return len(vals)

    if not shifted:
        for name in names:
            rows += deliver(name, STREAM_T_LIVE)
        return rows
    prov.inject(mean_shift=4.0)
    try:
        for k in range(2):  # 192 rows displace the healthy 128-row windows
            for name in shifted:
                rows += deliver(name, to_ns(STREAM_T_LIVE) + (k + 1) * 3_600_000_000_000)
    finally:
        prov.clear()
    return rows


def watchman_cli(proc, url: str) -> dict:
    """``run-watchman`` of the CLI (started with the replicas, over replica
    0): ``/healthcheck`` and ``/`` answer, and SIGTERM stops it with exit
    code 0."""
    t0 = time.perf_counter()
    try:
        while True:
            try:
                status, health = http_json(url + "/healthcheck")
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > CLI_TIMEOUT_S:
                    raise AssertionError(f"run-watchman did not answer (exit {proc.poll()})") from None
                time.sleep(0.2)
        status_root, root = http_json(url + "/")
        if status != 200 or "gordo-watchman-version" not in health or status_root != 200 or not root["endpoints"]:
            raise AssertionError(f"run-watchman answered {status} {health}, / {status_root}")
    finally:
        stop_server(proc)
    if proc.returncode != 0:
        raise AssertionError(f"run-watchman exited {proc.returncode} on SIGTERM")
    return {"endpoints": len(root["endpoints"]), "exit_on_sigterm": proc.returncode}


def watchman_phase(card: str):
    """The watchman's read side over three one-card replicas: each a
    ``run-server`` subprocess (``GORDO_STREAM=1``) over its own 6 dense
    and 2 ``lstm_hourglass`` detectors (10 tags, lookback 32) fitted on
    the card; the watchman in this process (``run_watchman(metrics_urls=
    ...)`` on a ``ReplayClock`` stepped past its refresh interval). It
    checks the snapshot (replica 0's members through ``GET /``, the
    others' through a snapshot of each replica), the routing table and a
    routed ``Client`` bitwise the owners' direct answers, the ``/metrics``
    sums against the replicas' own, the rollups' parts against each
    replica's endpoint, a drift sweep that flags exactly the two shifted
    members (``/`` degraded), the three fault points, a killed replica
    (dark in ``/routing``, frozen and stamped in ``/metrics``) and the
    CLI's ``run-watchman``. Returns the replicas' launch counts, summed."""
    from gordo_components_torch.dataset.data_provider.streaming import SimulatedLiveProvider
    from gordo_components_torch.replay.clock import ReplayClock
    from gordo_components_torch.resilience import faults
    from gordo_components_torch.watchman import run_watchman
    from gordo_components_torch.watchman.server import WatchmanState

    t_phase = time.perf_counter()
    shutil.rmtree(WATCHMAN_DIR, ignore_errors=True)
    os.makedirs(WATCHMAN_DIR)
    prov = SimulatedLiveProvider(freq="10s", noise=0.1, seed=11)
    t0 = time.perf_counter()
    names = {r: stream_models(prov, os.path.join(WATCHMAN_DIR, f"r{r}"), WATCHMAN_DENSE, WATCHMAN_LSTM,
                              prefix=f"w{r}", per_model=False) for r in range(WATCHMAN_REPLICAS)}
    fit_s = time.perf_counter() - t0
    members = sorted(n for r in names for n in names[r])
    owner = {n: r for r in names for n in names[r]}
    readings, runs, servers, logs, wm, cli_proc = {"fit_s": round(fit_s, 3)}, {}, [], [], None, None
    try:
        t0 = time.perf_counter()
        servers, bases, logs, cli_proc, cli_url = watchman_replicas(names)
        readings["replicas_ready_s"] = round(time.perf_counter() - t0, 3)
        prefixes = [f"{b}/gordo/v0/smoke" for b in bases]
        clock = ReplayClock(time.time())
        wm = run_watchman("smoke", bases[0], host="127.0.0.1", port=0, refresh_interval=WATCHMAN_REFRESH_S,
                          metrics_urls=[p + "/metrics" for p in prefixes], clock=clock, background=True)
        state = wm.state

        def get(path, headers=None):
            status, hdrs, raw = http_raw(wm.url + path, None, headers)
            return status, hdrs, raw

        def get_json(path):
            status, _, raw = get(path)
            if status != 200:
                raise AssertionError(f"watchman {path} answered {status}: {raw[:300]}")
            return json.loads(raw)

        def expire():  # the watchman's caches due again
            clock.advance(WATCHMAN_REFRESH_S)

        # 1. the routing table, the snapshot, every member healthy and banked
        t = time.perf_counter()
        table = get_json("/routing")
        readings["routing_build_s"] = round(time.perf_counter() - t, 4)
        if table["members"] != owner or not all(r["reachable"] and r["status"] == "ok" for r in table["replicas"]):
            raise AssertionError(f"watchman /routing: {table}")
        t = time.perf_counter()
        metrics_text = get("/metrics")[2].decode()
        readings["metrics_cold_s"] = round(time.perf_counter() - t, 4)
        t = time.perf_counter()
        get("/metrics")
        readings["metrics_cached_s"] = round(time.perf_counter() - t, 4)
        get_json("/drift")
        t = time.perf_counter()
        root = get_json("/")
        readings["snapshot_s"] = round(time.perf_counter() - t, 4)
        if ([e["target"] for e in root["endpoints"]] != names[0]
                or not all(e["healthy"] and e["banked"] is True for e in root["endpoints"])
                or [r["url"] for r in root["replicas"]] != bases or not all(r["reachable"] for r in root["replicas"])
                or root["fleet-metrics"]["replicas_scraped"] != WATCHMAN_REPLICAS or "status" in root):
            raise AssertionError(f"watchman /: {json.dumps(root)[:2000]}")
        for r in range(1, WATCHMAN_REPLICAS):  # the other replicas' members, a snapshot each
            snap = wm.app.run(WatchmanState("smoke", bases[r]).snapshot())
            if ([e["target"] for e in snap["endpoints"]] != names[r]
                    or not all(e["healthy"] and e["banked"] is True for e in snap["endpoints"])):
                raise AssertionError(f"watchman: replica {r}'s snapshot {json.dumps(snap)[:1000]}")
        if "gordo_fleet_routing_version 1" not in metrics_text:
            raise AssertionError("watchman /metrics: no routing version")

        # 2. a routed client, bitwise the owners' direct answers: both one
        # chunk at a time, so each replica scores each chunk alone
        t = time.perf_counter()
        routed = Client("smoke", base_url=bases[0], routing_url=wm.url, batch_size=WATCHMAN_BATCH, parallelism=1,
                        metadata_fallback_dataset=WATCHMAN_DATASET)
        results = {res.name: res for res in routed.predict(*WATCHMAN_SPAN)}
        routed_s = time.perf_counter() - t
        if sorted(results) != members or routed.routing_version != table["version"]:
            raise AssertionError(f"watchman: routed client scored {sorted(results)} at v{routed.routing_version}")
        rows = 0
        for r in range(WATCHMAN_REPLICAS):
            direct = Client("smoke", base_url=bases[r], batch_size=WATCHMAN_BATCH, parallelism=1, transport="tcp",
                            use_tensor=routed.use_tensor, metadata_fallback_dataset=WATCHMAN_DATASET)
            for res in direct.predict(*WATCHMAN_SPAN, targets=names[r]):
                got = results[res.name]
                if not (res.ok and got.ok) or not np.array_equal(got.predictions.values, res.predictions.values) \
                        or not np.array_equal(got.predictions.index, res.predictions.index):
                    raise AssertionError(f"watchman: routed {res.name} differs from replica {r}'s direct answer "
                                         f"({got.error_messages[:1]} {res.error_messages[:1]})")
                rows += len(got.predictions.values)
        readings["routed_rows_per_s_serial"] = round(rows / routed_s, 1)
        readings["routed_rows"] = rows

        # 3. the rollup's sums are the replicas' own, at one quiet moment
        expire()
        agg = wm.app.run(state.fleet_metrics())
        direct = [request_counters(http_raw(p + "/metrics")[2].decode()) for p in prefixes]
        want = {}
        for counters in direct:
            for labels, value in counters.items():
                want[labels] = want.get(labels, 0.0) + value
        if agg["replicas_scraped"] != WATCHMAN_REPLICAS or summed_counters(agg) != want or not want:
            raise AssertionError(f"watchman /metrics sums {summed_counters(agg)} != replicas' {want}")
        text = get("/metrics")[2].decode()
        if f"gordo_fleet_replicas_scraped {WATCHMAN_REPLICAS}" not in text:
            raise AssertionError("watchman /metrics: replicas_scraped")
        sums_before = summed_counters(agg)

        # 4. the rollups: each replica's part is its own endpoint's
        checks = {}
        for path, (suffix, theirs, own) in WATCHMAN_ROLLUPS.items():
            before = [own(http_json(p + suffix)[1], i) for i, p in enumerate(prefixes)]
            body = get_json(path)
            for i, p in enumerate(prefixes):
                part = theirs(body, i)
                # a request in between may move the replica: its answer just before or just after
                if part != before[i] and part != own(http_json(p + suffix)[1], i):
                    raise AssertionError(f"watchman {path}: replica {i}'s part {json.dumps(part)[:300]} is not "
                                         f"its own {json.dumps(before[i])[:300]}")
            checks[path] = "each replica's part its own"

        # 5. drift: healthy windows flag nothing; a mean shift flags its two members
        cursor = [time.time() - 3600.0]
        ingested = watchman_ingest(prov, bases[0], names[0], (), cursor)
        drift = get_json("/drift?refresh=1")
        if drift["drifted"] != [] or drift["replicas_streaming"] != WATCHMAN_REPLICAS:
            raise AssertionError(f"watchman: healthy windows drifted: {drift}")
        shifted = names[0][:WATCHMAN_SHIFTED]
        ingested += watchman_ingest(prov, bases[0], names[0], shifted, cursor)
        t = time.perf_counter()
        drift = get_json("/drift?refresh=1")
        readings["drift_sweep_s"] = round(time.perf_counter() - t, 4)
        root = get_json("/")
        if drift["drifted"] != sorted(shifted) or root.get("status") != "degraded":
            raise AssertionError(f"watchman: /drift flagged {drift['drifted']}, shifted {shifted}; "
                                 f"/ {root.get('status')}")
        readings["degraded_reason"] = root["degraded_reason"]
        incidents = get_json("/incidents")
        readings["drifted"] = drift["drifted"]
        readings["ingested_rows"] = ingested

        # 6. the fault points, armed here
        faults.arm("watchman.scrape", times=WATCHMAN_REPLICAS)
        expire()
        agg = wm.app.run(state.fleet_metrics())
        status, _, raw = get("/metrics")
        fell = {k: v for k, v in summed_counters(agg).items() if v < sums_before.get(k, 0.0)}
        if agg["replicas_scraped"] != 0 or status != 200 or fell or b"gordo_fleet_replicas_scraped 0" not in raw:
            raise AssertionError(f"watchman.scrape: scraped {agg['replicas_scraped']}, status {status}, fell {fell}")
        faults.arm("watchman.snapshot", times=1)
        expire()
        stale = get_json("/")
        if stale.get("stale") is not True or "FaultInjected" not in stale.get("refresh_error", ""):
            raise AssertionError(f"watchman.snapshot: / answered {json.dumps(stale)[:500]}")
        version = get_json("/routing?refresh=1")["version"]
        faults.configure_from_env(f"watchman.probe=refuse,times={WATCHMAN_REPLICAS}")
        dark = get_json("/routing?refresh=1")
        healed = get_json("/routing?refresh=1")
        events = get_json("/events?type=mesh.replica_unreachable,mesh.replica_recovered")["events"]
        kinds = [e["type"] for e in events]
        if (dark["version"] <= version or any(r["reachable"] for r in dark["replicas"])
                or healed["version"] <= dark["version"] or not all(r["reachable"] for r in healed["replicas"])
                or kinds != ["mesh.replica_unreachable"] * WATCHMAN_REPLICAS
                + ["mesh.replica_recovered"] * WATCHMAN_REPLICAS):
            raise AssertionError(f"watchman.probe: v{version} -> {dark['version']} -> {healed['version']}, {kinds}")
        faults.reset()
        checks["faults"] = {"scrape": "replicas_scraped 0, no sum fell", "snapshot": "last good, stale",
                            "probe": [version, dark["version"], healed["version"]]}

        # 7. a replica killed: dark in /routing, its members unhealthy, its counters frozen and stamped
        expire()
        wm.app.run(state.fleet_metrics())
        stop_server(servers[2])
        killed = get_json("/routing?refresh=1")
        if killed["replicas"][2]["reachable"] or any(owner[n] == 2 for n in killed["members"]):
            raise AssertionError(f"watchman: a killed replica in /routing: {killed}")
        snap = wm.app.run(WatchmanState("smoke", bases[2], targets=names[2]).snapshot())
        if [e["target"] for e in snap["endpoints"]] != names[2] or any(e["healthy"] for e in snap["endpoints"]):
            raise AssertionError(f"watchman: the killed replica's members {snap['endpoints']}")
        expire()
        agg = wm.app.run(state.fleet_metrics())
        text = get("/metrics")[2].decode()
        fell = {k: v for k, v in summed_counters(agg).items() if v < sums_before.get(k, 0.0)}
        if (agg["replicas_scraped"] != WATCHMAN_REPLICAS - 1 or fell
                or f'gordo_fleet_scrape_stale_seconds{{replica="2"}} {WATCHMAN_REFRESH_S:g}' not in text):
            raise AssertionError(f"watchman: after the kill scraped {agg['replicas_scraped']}, fell {fell}")
        checks["killed"] = "unreachable, 8 unhealthy, frozen and stamped"

        # 9. the CLI's run-watchman over one replica
        readings["cli"] = watchman_cli(cli_proc, cli_url)
    finally:
        faults.reset()
        if wm is not None:
            wm.close()
        for server in servers + ([cli_proc] if cli_proc is not None else []):
            stop_server(server)
        for log in logs:
            log.close()
    for r, server in enumerate(servers):
        if server.returncode != 0:
            raise AssertionError(f"watchman replica {r} exited {server.returncode} on SIGTERM")
        runs[f"replica_{r}"] = cli_counts(f"watchman_replica_{r}", counts_dir=WATCHMAN_DIR)
    shutil.rmtree(WATCHMAN_DIR, ignore_errors=True)
    total = {k: sum(c[k] for c in runs.values()) for k in runs["replica_0"]}
    if total["banked_anomaly_score"] <= 0 or total["lstm_layer"] <= 0:
        raise AssertionError(f"watchman: the replicas launched {runs}")
    readings["wall_s"] = round(time.perf_counter() - t_phase, 3)
    phase("watchman", members=len(members), replicas=WATCHMAN_REPLICAS, checks=json.dumps(checks),
          incidents=incidents["detected"], launches_by_run=json.dumps(runs),
          **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in readings.items()},
          card=json.dumps(card))
    return total


PLACEMENT_DIR = os.path.join(ROOT, "build", "chip_smoke_placement")
PLACEMENT_SHARDS = 4  # logical shards of the one card
PLACEMENT_DENSE, PLACEMENT_LSTM = 256, 16  # config 1's dense (the smoke's random_entry) and config 2's lstm_hourglass
PLACEMENT_HOT, PLACEMENT_HOT_WEIGHT = 8, 16  # the hot members, all in shard 0 at boot, and their requests a round
PLACEMENT_ROWS = 64  # rows a request (past the LSTM warm-up of 31)
PLACEMENT_ENV = {"GORDO_REBALANCE_MIN_ROWS": "1", "GORDO_SERVER_WARMUP": "0"}
SHARD_BAND = dict(rtol=1e-5, atol=1e-6)  # the engine's band (tests/test_bank_sharded.py:233-240)


def placement_entries() -> dict:
    rng = np.random.default_rng(25)
    entries = {f"p-dense-{i:03d}": random_entry(f"p-dense-{i:03d}", 10, rng) for i in range(PLACEMENT_DENSE)}
    entries.update({f"p-lstm-{i:02d}": random_lstm_entry(f"p-lstm-{i:02d}", "LSTMAutoEncoder", rng)
                    for i in range(PLACEMENT_LSTM)})
    return entries


def shard_rows_of(registry) -> dict:
    snap = registry.snapshot()
    return {v["labels"]["shard"]: v["value"]
            for v in snap.get("gordo_bank_shard_routed_rows_total", {}).get("values", [])}


def sharded_against_unsharded(entries: dict, mesh) -> dict:
    """The sharded bank's answers against the unsharded bank's at the same
    batch composition (one request at a time, and one heterogeneous batch
    of every member), and its launches a shard."""
    rng = np.random.default_rng(26)
    flat = ModelBank.from_entries(list(entries.values()), registry=False)
    sharded = ModelBank.from_entries(list(entries.values()), mesh=mesh, registry=False)
    names = sorted(entries)
    X = {n: rng.standard_normal((PLACEMENT_ROWS, 10)).astype(np.float32) for n in names}
    requests = [(n, X[n], None) for n in names]
    singles = [names[0], names[PLACEMENT_DENSE // 2], names[PLACEMENT_DENSE - 1], names[-1]]
    reading = {"single_bitwise": True, "batch_bitwise": True, "batch_max_abs_dev": 0.0, "batch_max_rel_dev": 0.0}
    for n in singles:
        a, b = flat.score(n, X[n]), sharded.score(n, X[n])
        for key, w in a.to_arrays().items():
            if not np.array_equal(b.to_arrays()[key], w):
                reading["single_bitwise"] = False
                np.testing.assert_allclose(b.to_arrays()[key], w, **SHARD_BAND, err_msg=f"placement single {n} {key}")
    before = dict(sharded.shard_launches)
    k2, k3 = score.launch_counts["banked_anomaly_score"], seq_scan.launch_counts["lstm_layer"]
    got = sharded.score_many(requests)
    torch.cuda.synchronize()
    per_shard = {d: sharded.shard_launches[d] - before.get(d, 0) for d in sorted(sharded.shard_launches)}
    k2, k3 = score.launch_counts["banked_anomaly_score"] - k2, seq_scan.launch_counts["lstm_layer"] - k3
    n_layers = next(b for b in sharded._buckets.values() if b.lookback > 1).shards[0].n_layers
    if (sorted(per_shard) != list(range(PLACEMENT_SHARDS)) or set(per_shard.values()) != {2}
            or k2 != sum(per_shard.values()) or k3 != PLACEMENT_SHARDS * n_layers):
        raise AssertionError(f"placement: launches a shard {per_shard}, K2 {k2}, K3 {k3}")
    want = flat.score_many(requests)
    for (n, _X, _y), g, w in zip(requests, got, want):
        for key, wv in w.to_arrays().items():
            gv = g.to_arrays()[key]
            if not np.array_equal(gv, wv):
                reading["batch_bitwise"] = False
                dev = float(np.abs(gv - wv).max())
                reading["batch_max_abs_dev"] = max(reading["batch_max_abs_dev"], dev)
                reading["batch_max_rel_dev"] = max(reading["batch_max_rel_dev"],
                                                   float((np.abs(gv - wv) / np.maximum(np.abs(wv), 1e-30)).max()))
                np.testing.assert_allclose(gv, wv, **SHARD_BAND, err_msg=f"placement batch {n} {key}")
    reading.update(launches_per_shard=per_shard, k2=k2, k3=k3)
    del flat, sharded
    return reading


def placement_round(base: str, weights: dict, rng, statuses: list) -> None:
    """Every member's requests of one round, from 8 client threads."""
    jobs = [n for n, w in weights.items() for _ in range(w)]
    rng.shuffle(jobs)
    X = rng.standard_normal((PLACEMENT_ROWS, 10)).astype(np.float32).tolist()

    def post(chunk):
        for n in chunk:
            statuses.append(http_json(f"{base}/gordo/v0/smoke/{n}/anomaly/prediction", {"X": X})[0])

    threads = [threading.Thread(target=post, args=(jobs[i::8],)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def placement_phase(card: str):
    """The sharded bank and the placement plane on 4 logical shards of the
    card: 256 dense and 16 ``lstm_hourglass`` members (random weights from a
    seed, 10 tags), the sharded bank held against the unsharded one and its
    K2/K3 launches counted a shard; then ``run_server(devices=4)`` over
    them under skewed traffic (8 hot members, all on shard 0 at boot):
    ``/placement``'s skew, ``POST /rebalance`` applied under a POSTing
    thread (no answer but 200), the next window's measured skew, the
    generation, and the ``bank.swap`` fault's 500 with the bank's series
    unchanged and serving going on."""
    from gordo_components_torch.parallel import mesh as mesh_module
    from gordo_components_torch.placement.planner import skew_ratio
    from gordo_components_torch.resilience import faults

    t_phase = time.perf_counter()
    shutil.rmtree(PLACEMENT_DIR, ignore_errors=True)
    entries = placement_entries()
    for name, entry in entries.items():
        serializer.dump(entry, os.path.join(PLACEMENT_DIR, name))
    mesh = mesh_module.fleet_mesh(devices=[resolve_device("cuda")] * PLACEMENT_SHARDS)
    card_dev = mesh.devices[0]
    readings = {"bank": sharded_against_unsharded(entries, mesh)}
    available = mesh_module.available_devices
    mesh_module.available_devices = lambda kind="cuda": [card_dev] * PLACEMENT_SHARDS
    server, rng, statuses = None, np.random.default_rng(27), []
    try:
        with env_set(PLACEMENT_ENV):
            server = run_server(PLACEMENT_DIR, host="127.0.0.1", port=0, background=True, devices=PLACEMENT_SHARDS)
        base, registry = server.url, server.app.metrics
        prefix = f"{base}/gordo/v0/smoke"
        _, models = http_json(prefix + "/models")
        if models["bank"]["devices"] != PLACEMENT_SHARDS or len(models["bank"]["banked"]) != len(entries):
            raise AssertionError(f"placement /models: {models['bank']['devices']} shards")
        _, place = http_json(prefix + "/placement")
        dense = next(b for b in place["buckets"] if len(b["members"]) == PLACEMENT_DENSE)
        hot = dense["members"][:PLACEMENT_HOT]  # shard 0's first members
        weights = {n: PLACEMENT_HOT_WEIGHT if n in hot else 1 for n in sorted(entries)}

        def measured(round_fn):
            before = shard_rows_of(registry)
            round_fn()
            now = shard_rows_of(registry)
            return skew_ratio([now[s] - before.get(s, 0.0) for s in sorted(now)])

        skew_before = measured(lambda: placement_round(base, weights, rng, statuses))
        _, view = http_json(prefix + "/placement?dry_run=1")
        load_statuses, stop = [], threading.Event()

        def load():
            X = rng.standard_normal((PLACEMENT_ROWS, 10)).astype(np.float32).tolist()
            i = 0
            while not stop.is_set():
                n = hot[i % len(hot)]
                i += 1
                load_statuses.append(http_json(f"{prefix}/{n}/anomaly/prediction", {"X": X})[0])

        loader = threading.Thread(target=load)
        loader.start()
        try:
            status, body = http_json(prefix + "/rebalance", {})
        finally:
            stop.set()
            loader.join()
        if status != 200 or not body["applied"]:
            raise AssertionError(f"placement: POST /rebalance answered {status}: {json.dumps(body)[:1000]}")
        skew_after = measured(lambda: placement_round(base, weights, rng, statuses))
        metrics = http_raw(prefix + "/metrics")[2].decode()
        if (skew_after is None or skew_after >= skew_before or "gordo_bank_generation 1" not in metrics
                or set(load_statuses) != {200} or set(statuses) != {200}):
            raise AssertionError(f"placement: skew {skew_before} -> {skew_after}, answers {sorted(set(statuses))}, "
                                 f"under the swap {sorted(set(load_statuses))}")
        readings.update(observed_skew=view["observed"]["skew_ratio"], plan_skew=[view["plan"]["skew_before"],
                        view["plan"]["skew_after"]], moved=body["plan"]["moved"],
                        skew_before=skew_before, skew_after=skew_after, pause_ms=body["swap"]["pause_ms"],
                        build_s=body["swap"]["build_s"], drained=body["swap"]["drained"],
                        posts_under_swap=len(load_statuses), non_200_under_swap=sum(s != 200 for s in load_statuses))

        # the bank.swap fault: a new skew (shard 0's first members now), a
        # rebalance that fails mid-flip and rolls back, serving on
        _, place = http_json(prefix + "/placement")
        dense = next(b for b in place["buckets"] if len(b["members"]) == PLACEMENT_DENSE)
        weights = {n: PLACEMENT_HOT_WEIGHT if n in dense["members"][:PLACEMENT_HOT] else 1 for n in sorted(entries)}
        placement_round(base, weights, rng, statuses)
        bank_series = [line for line in registry.render().splitlines() if line.startswith("gordo_bank_")]
        faults.arm("bank.swap", times=1)
        try:
            status, body = http_json(prefix + "/rebalance", {"force": True})
        finally:
            faults.disarm("bank.swap")
        after = [line for line in registry.render().splitlines() if line.startswith("gordo_bank_")]
        served = http_json(f"{prefix}/{hot[0]}/anomaly/prediction",
                           {"X": rng.standard_normal((PLACEMENT_ROWS, 10)).tolist()})[0]
        failed = registry.snapshot()["gordo_rebalance_failed_total"]["values"][0]["value"]
        if status != 500 or not body.get("rolled_back") or body["generation"] != 1 or after != bank_series \
                or served != 200 or failed != 1:
            raise AssertionError(f"placement bank.swap: {status} {body}, series changed "
                                 f"{sorted(set(after) ^ set(bank_series))[:8]}, "
                                 f"serving {served}, failed {failed}")
        readings["fault"] = {"status": status, "rolled_back": body["rolled_back"], "generation": body["generation"],
                             "bank_series_unchanged": True, "then_served": served}
        events = http_json(prefix + "/events?type=rebalance.applied,bank.swap_failed")[1]["events"]
        readings["events"] = [e["type"] for e in events]
    finally:
        mesh_module.available_devices = available
        if server is not None:
            server.close()
    shutil.rmtree(PLACEMENT_DIR, ignore_errors=True)
    readings["wall_s"] = round(time.perf_counter() - t_phase, 3)
    phase("placement", members=len(entries), shards=PLACEMENT_SHARDS,
          **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in readings.items()},
          card=json.dumps(card))


MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")
MESH_REPLICAS = 3
MESH_DENSE, MESH_LSTM = 18, 6  # over one shared directory: 24 members, as many as the watchman step's replicas hold
MESH_ROWS = 64


def mesh_replicas(root: str) -> tuple:
    """Each replica's counted ``run-server`` with ``GORDO_MESH_REPLICA_ID``
    and ``GORDO_MESH_REPLICAS`` over the one shared directory, started at
    once; (processes, base URLs, logs)."""
    servers, bases, logs, t0 = [], [], [], time.perf_counter()
    for r in range(MESH_REPLICAS):
        port = free_port()
        log = open(os.path.join(MESH_DIR, f"replica-{r}.log"), "w")
        env = dict(os.environ, GORDO_MESH_REPLICA_ID=str(r), GORDO_MESH_REPLICAS=str(MESH_REPLICAS),
                   GORDO_SERVER_WARMUP="0")
        servers.append(subprocess.Popen(
            cli_command(f"mesh_replica_{r}", ["run-server", "--model-dir", root, "--host", "127.0.0.1",
                                              "--port", str(port)], counts_dir=MESH_DIR),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env))
        bases.append(f"http://127.0.0.1:{port}")
        logs.append(log)
    for base, server in zip(bases, servers):
        wait_for_models(f"{base}/gordo/v0/smoke", server, t0)
    return servers, bases, logs


def mesh_score(base: str, name: str, X: np.ndarray):
    status, _, raw = http_raw(f"{base}/gordo/v0/smoke/{name}/anomaly/prediction", tensor_body(X), TENSOR_HEADERS)
    return status, raw


def mesh_phase(card: str):
    """The serving mesh across three one-card replicas: ``run-server``
    subprocesses with ``GORDO_MESH_REPLICA_ID``/``GORDO_MESH_REPLICAS`` over
    one shared directory of 18 dense and 6 ``lstm_hourglass`` members
    (random weights from a seed, 10 tags), the watchman (``run_watchman``)
    over them. The partitions are disjoint and exhaustive; ``POST
    /migrate`` moves a member from replica 0 to 1 while a client follows the
    routing table (refetching it once on a 404, as the bulk client does)
    and POSTs (no answer but 200, the routing version steps, the answers
    bitwise before, during and after); an acquire with
    ``source`` ships an artifact into a replica over its own root; a forced
    ``/fleet-rebalance`` moves a member; ``gordo_fleet_migrations_total``
    counts each move. Returns the replicas' launch counts, summed."""
    from gordo_components_torch.parallel.distributed import partition_members
    from gordo_components_torch.watchman import run_watchman

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    root = os.path.join(MESH_DIR, "shared")
    rng = np.random.default_rng(28)
    names = [f"m-dense-{i:02d}" for i in range(MESH_DENSE)] + [f"m-lstm-{i:02d}" for i in range(MESH_LSTM)]
    for name in names:
        entry = (random_entry(name, 10, rng) if "dense" in name
                 else random_lstm_entry(name, "LSTMAutoEncoder", rng))
        serializer.dump(entry, os.path.join(root, name))
    readings, runs, servers, logs, wm, own = {}, {}, [], [], None, None
    try:
        t0 = time.perf_counter()
        servers, bases, logs = mesh_replicas(root)
        readings["replicas_ready_s"] = round(time.perf_counter() - t0, 3)
        prefixes = [f"{b}/gordo/v0/smoke" for b in bases]
        owned = [http_json(p + "/mesh")[1] for p in prefixes]
        parts = [o["owned"] for o in owned]
        flat = [n for p in parts for n in p]
        if (sorted(flat) != sorted(names) or len(set(flat)) != len(names)
                or parts != [partition_members(names, r, MESH_REPLICAS) for r in range(MESH_REPLICAS)]
                or [(o["replica_id"], o["replica_count"]) for o in owned] != [(r, MESH_REPLICAS)
                                                                                for r in range(MESH_REPLICAS)]):
            raise AssertionError(f"mesh: partitions {parts}")
        wm = run_watchman("smoke", bases[0], host="127.0.0.1", port=0, refresh_interval=0.5,
                          metrics_urls=[p + "/metrics" for p in prefixes], background=True)
        table = http_json(wm.url + "/routing?refresh=1")[1]
        if table["members"] != {n: r for r, p in enumerate(parts) for n in p}:
            raise AssertionError(f"mesh /routing: {table}")

        # 1. a migration under load, bitwise before, during and after
        member = next(n for n in parts[0] if "lstm" in n) if any("lstm" in n for n in parts[0]) else parts[0][0]
        X = rng.standard_normal((MESH_ROWS, 10)).astype(np.float32)
        status, want = mesh_score(bases[0], member, X)
        statuses, answers, rerouted, stop = [], [], [], threading.Event()

        def load():
            # a client that follows the table, refetching it once on a 404
            # (a table read before the release), as the bulk client does
            while not stop.is_set():
                status, raw = mesh_score(bases[http_json(wm.url + "/routing")[1]["members"].get(member, 0)], member, X)
                if status == 404:
                    rerouted.append(1)
                    owner = http_json(wm.url + "/routing?refresh=1")[1]["members"][member]
                    status, raw = mesh_score(bases[owner], member, X)
                statuses.append(status)
                answers.append(raw)

        loader = threading.Thread(target=load)
        loader.start()
        t = time.perf_counter()
        try:
            status, verdict = http_json(wm.url + "/migrate", {"member": member, "to": 1})
        finally:
            migrate_s = time.perf_counter() - t
            time.sleep(0.5)  # a few answers after the move
            stop.set()
            loader.join()
        after = http_json(wm.url + "/routing?refresh=1")[1]
        if (status != 200 or not verdict["moved"] or set(statuses) != {200} or any(a != want for a in answers)
                or after["members"][member] != 1 or after["version"] <= table["version"]
                or mesh_score(bases[1], member, X) != (200, want)
                or member in http_json(prefixes[0] + "/mesh")[1]["owned"]):
            raise AssertionError(f"mesh /migrate of {member}: {status} {json.dumps(verdict)[:600]}, answers "
                                 f"{sorted(set(statuses))}, bitwise {all(a == want for a in answers)}")
        readings.update(migrated=member, migrate_s=round(migrate_s, 3), posts_under_migration=len(statuses),
                        non_200=sum(s != 200 for s in statuses), rerouted=len(rerouted), bitwise=True,
                        routing_version=[table["version"], after["version"]],
                        acquire_pause_ms=verdict["acquire"]["swap"]["pause_ms"],
                        release_pause_ms=verdict["release"]["swap"]["pause_ms"])

        # 2. an acquire with source, into a replica over its own root
        own_root = os.path.join(MESH_DIR, "own")
        shipped = parts[2][0]
        shutil.copytree(os.path.join(root, parts[1][0]), os.path.join(own_root, parts[1][0]))
        with env_set({"GORDO_SERVER_WARMUP": "0"}):
            own = run_server(own_root, host="127.0.0.1", port=0, background=True)
        status, body = http_json(own.url + "/gordo/v0/smoke/mesh/acquire", {"member": shipped, "source": bases[2]})
        if status != 200 or not body["shipped"] or mesh_score(own.url, shipped, X) != mesh_score(bases[2], shipped, X):
            raise AssertionError(f"mesh acquire with source: {status} {json.dumps(body)[:600]}")
        readings["shipped"] = {"member": shipped, "pause_ms": body["swap"]["pause_ms"]}

        # 3. a forced /fleet-rebalance: replica 2's members made the
        # hottest, twice replica 1's window (the migration's load)
        hottest = max(sum(http_json(p + "/placement")[1]["member_rows"].values()) for p in prefixes[:2])
        for _ in range(2 + int(2 * hottest) // (MESH_ROWS * len(parts[2]))):
            for n in parts[2]:
                if mesh_score(bases[2], n, X)[0] != 200:
                    raise AssertionError(f"mesh: {n} on replica 2")
        status, result = http_json(wm.url + "/fleet-rebalance", {"force": True})
        moves = [m for m in result.get("moves", []) if m["moved"]]
        if status != 200 or not moves or result["applied"] != len(moves):
            raise AssertionError(f"mesh /fleet-rebalance: {status} {json.dumps(result)[:1000]}")
        text = http_raw(wm.url + "/metrics")[2].decode()
        if f"gordo_fleet_migrations_total {1 + len(moves)}" not in text:
            raise AssertionError(f"mesh: gordo_fleet_migrations_total after {1 + len(moves)} moves")
        final = http_json(wm.url + "/routing?refresh=1")[1]
        if any(final["members"][m["member"]] != m["dst"] for m in moves) or sorted(final["members"]) != sorted(names):
            raise AssertionError(f"mesh: the routing after the fleet moves {final}")
        readings.update(fleet_moves=[[m["member"], m["src"], m["dst"]] for m in moves],
                        fleet_plan=result["plan"]["reason"], migrations_total=1 + len(moves))
    finally:
        if own is not None:
            own.close()
        if wm is not None:
            wm.close()
        for server in servers:
            stop_server(server)
        for log in logs:
            log.close()
    for r, server in enumerate(servers):
        if server.returncode != 0:
            raise AssertionError(f"mesh replica {r} exited {server.returncode} on SIGTERM")
        runs[f"replica_{r}"] = cli_counts(f"mesh_replica_{r}", counts_dir=MESH_DIR)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    total = {k: sum(c[k] for c in runs.values()) for k in runs["replica_0"]}
    if total["banked_anomaly_score"] <= 0 or total["lstm_layer"] <= 0:
        raise AssertionError(f"mesh: the replicas launched {runs}")
    readings["wall_s"] = round(time.perf_counter() - t_phase, 3)
    phase("mesh", members=len(names), replicas=MESH_REPLICAS, launches_by_run=json.dumps(runs),
          **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in readings.items()},
          card=json.dumps(card))
    return total


WORKFLOW_DIR = os.path.join(ROOT, "build", "chip_smoke_workflow")
WORKFLOW_REPLICAS = 2  # at the spec's canary slice of 0.25: one canary replica, one promoted
WORKFLOW_GATE = ["replica_crash_restart", "gray_failure_slow_replica"]
WORKFLOW_ROWS = 64  # rows a scoring request (past turbine-lstm's lookback of 12)
WORKFLOW_EDITED = "compressor-a"  # the machine the second and third runs edit
WORKFLOW_FAULT = "workflow.canary=error,times=1"


def workflow_spec(revs: dict) -> str:
    """examples/fleet.yaml plus the game-day gate and a ``rev`` in each
    machine's metadata (``revs``, else 1), written as JSON (a YAML flow
    document) under build/; its path."""
    with open(FLEET_YAML) as f:
        spec = safe_load(f)
    spec["fleet"]["gameday"] = {"gate": list(WORKFLOW_GATE)}
    for machine in spec["machines"]:
        machine["metadata"] = dict(machine.get("metadata") or {}, rev=revs.get(machine["name"], 1))
    path = os.path.join(WORKFLOW_DIR, "fleet.json")
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    return path


def served_rev(base: str, name: str):
    status, body = http_json(f"{base}/gordo/v0/smoke/{name}/metadata")
    return body["endpoint-metadata"]["user-defined"].get("rev") if status == 200 else status


class WorkflowTraffic:
    """A thread that scores every member on every replica through the tensor
    wire, in turns, until stopped; every status it got."""

    def __init__(self, bases, names, rng):
        self.targets = [(b, n) for n in names for b in bases]
        self.X = rng.standard_normal((WORKFLOW_ROWS, 3)).astype(np.float32)
        self.X2 = rng.standard_normal((WORKFLOW_ROWS, 2)).astype(np.float32)
        self.statuses, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            base, name = self.targets[i % len(self.targets)]
            X = self.X2 if name == "turbine-lstm" else self.X
            self.statuses.append(mesh_score(base, name, X)[0])
            i += 1
            time.sleep(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def workflow_events(bases, since: dict) -> dict:
    """Each replica's ``bank.swap`` pauses (ms) after ``since``'s sequence
    numbers, which move on to the newest."""
    out = {}
    for r, base in enumerate(bases):
        events = http_json(f"{base}/gordo/v0/smoke/events?type=bank.swap")[1]["events"]
        fresh = [e for e in events if e["seq"] > since.get(r, 0)]
        if fresh:
            since[r] = fresh[-1]["seq"]
        out[r] = [e["attrs"]["pause_ms"] for e in fresh]
    return out


def workflow_placement(state: str) -> dict:
    """The executor's member -> replica assignment (replica index as a
    string -> names), as its last place step recorded it."""
    with open(os.path.join(state, "fleet_state.json")) as f:
        return json.load(f)["placement"]


def workflow_run(run: str, spec: str, bases, collections, state: str, traffic, env=None) -> tuple:
    """One counted ``workflow run`` of the CLI over the replicas under the
    traffic; (exit code, report, wall s)."""
    args = ["workflow", "run", "-f", spec, "-p", "smoke", "--state-dir", state]
    for base, cdir in zip(bases, collections):
        args += ["--server-url", base, "--collection-dir", cdir]
    t = time.perf_counter()
    proc = cli(run, args, env=env, counts_dir=WORKFLOW_DIR)
    wall = round(time.perf_counter() - t, 3)
    try:
        report = json.loads(proc.stdout)
    except json.JSONDecodeError:
        raise AssertionError(f"workflow {run} exited {proc.returncode}: {proc.stdout[-1000:]} "
                             f"{proc.stderr[-3000:]}") from None
    return proc.returncode, report, wall


def workflow_phase(card: str):
    """The rollout's run side on the card: ``workflow run`` (the fleet
    executor, one counted CLI process a run) over two counted ``run-server``
    replicas, each over a collection of its own seeded with the incumbent,
    a plan-only run of the same spec at ``rev`` 0. Run 1 (``rev`` 1):
    every step executed, the gate passed, the served ``rev`` 1 on each
    replica's assigned members; run 2 edits one machine: its build, its
    bucket and the rollout tail executed, the rest cached; run 3 edits it
    again with ``workflow.canary`` armed in the executor's process: exit 84,
    a ``fleet.rollback``, the incumbent (run 2's) served again with answers
    bitwise those before the run. A thread scores every member on both
    replicas through the tensor wire in every run: no answer but 200.
    Returns the launch counts of the replicas and the CLI runs, summed."""
    t_phase = time.perf_counter()
    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    os.makedirs(WORKFLOW_DIR)
    state = os.path.join(WORKFLOW_DIR, "state")
    rng = np.random.default_rng(26)
    readings, runs, servers, logs = {}, {}, [], []
    with open(FLEET_YAML) as f:
        names = sorted(m["name"] for m in safe_load(f)["machines"])

    # the incumbent: a plan-only run (no replica) of the spec at rev 0
    spec = workflow_spec({n: 0 for n in names})
    rc, report, wall = workflow_run("workflow_plan", spec, [], [], state, None)
    if rc != 0 or report["failed"] or report["steps"]["promote/fleet"]["status"] != "planned":
        raise AssertionError(f"workflow plan-only run exited {rc}: {json.dumps(report)[:2000]}")
    runs["workflow_plan"] = cli_counts("workflow_plan", counts_dir=WORKFLOW_DIR)
    readings["plan_wall_s"] = wall
    artifacts = os.path.join(state, "artifacts")
    collections = [os.path.join(WORKFLOW_DIR, f"collection-{r}") for r in range(WORKFLOW_REPLICAS)]
    for cdir in collections:
        for name in names:
            shutil.copytree(os.path.join(artifacts, name), os.path.join(cdir, name))
    try:
        t0 = time.perf_counter()
        bases = []
        for r, cdir in enumerate(collections):
            port = free_port()
            log = open(os.path.join(WORKFLOW_DIR, f"replica-{r}.log"), "w")
            servers.append(subprocess.Popen(
                cli_command(f"workflow_replica_{r}", ["run-server", "--model-dir", cdir, "--host", "127.0.0.1",
                                                      "--port", str(port)], counts_dir=WORKFLOW_DIR),
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            bases.append(f"http://127.0.0.1:{port}")
            logs.append(log)
        for base, server in zip(bases, servers):
            wait_for_models(f"{base}/gordo/v0/smoke", server, t0)
        readings["replicas_ready_s"] = round(time.perf_counter() - t0, 3)
        since = {}
        workflow_events(bases, since)

        # run 1: promote
        spec = workflow_spec({})
        with WorkflowTraffic(bases, names, rng) as traffic:
            rc, report, wall = workflow_run("workflow_promote", spec, bases, collections, state, traffic)
        gate = report.get("gameday_gate") or {}
        placement = workflow_placement(state)
        revs = {r: {n: served_rev(bases[r], n) for n in placement[str(r)]} for r in range(WORKFLOW_REPLICAS)}
        if (rc != 0 or report["failed"] or report["cached"] or not report["promoted"]
                or sorted(report["executed"]) != sorted(report["steps"]) or not gate.get("passed")
                or sorted(gate["scenarios"]) != sorted(WORKFLOW_GATE) or set(traffic.statuses) != {200}
                or any(v != 1 for rv in revs.values() for v in rv.values())
                or sorted(n for part in placement.values() for n in part) != names):
            raise AssertionError(f"workflow promote: exit {rc}, statuses {sorted(set(traffic.statuses))}, revs "
                                 f"{revs}: {json.dumps(report, default=str)[:3000]}")
        readings["promote"] = {
            "wall_s": wall, "executed": len(report["executed"]), "verdict": report["canary"]["decision"],
            "reason": report["canary"]["reason"], "window": report.get("canary_window"),
            "gate_walls_s": {n: v["wall_seconds"] for n, v in gate["scenarios"].items()},
            "gate_non_200": {n: v["non_200"] for n, v in gate["scenarios"].items()},
            "posts": len(traffic.statuses), "non_200": 0, "placement": placement,
            "pause_ms": workflow_events(bases, since)}
        runs["workflow_promote"] = cli_counts("workflow_promote", counts_dir=WORKFLOW_DIR)

        # run 2: one machine edited
        spec = workflow_spec({WORKFLOW_EDITED: 2})
        with WorkflowTraffic(bases, names, rng) as traffic:
            rc, report, wall = workflow_run("workflow_edit", spec, bases, collections, state, traffic)
        with open(os.path.join(state, "fleet_dag.json")) as f:
            dag_steps = json.load(f)["steps"]
        bucket = next(st["id"] for st in dag_steps if f"build/{WORKFLOW_EDITED}" in st.get("deps", ()))
        tail = [st["id"] for st in dag_steps if st["kind"] in ("place", "canary", "gameday", "promote")]
        placement = workflow_placement(state)
        # the edited machine sits on the canary replica (the first), so the
        # fault run's rollback has its bytes to restore
        owner_base = bases[next(int(r) for r, part in placement.items() if WORKFLOW_EDITED in part)]
        if (rc != 0 or report["failed"] or not report["promoted"] or owner_base != bases[0]
                or sorted(report["executed"]) != sorted([f"build/{WORKFLOW_EDITED}", bucket, *tail])
                or sorted(report["cached"]) != sorted(set(report["steps"]) - set(report["executed"]))
                or set(traffic.statuses) != {200} or served_rev(owner_base, WORKFLOW_EDITED) != 2):
            raise AssertionError(f"workflow edit: exit {rc}, statuses {sorted(set(traffic.statuses))}: "
                                 f"{json.dumps(report, default=str)[:3000]}")
        readings["edit"] = {"wall_s": wall, "executed": report["executed"], "cached": report["cached"],
                            "verdict": report["canary"]["decision"], "reason": report["canary"]["reason"],
                            "posts": len(traffic.statuses), "non_200": 0,
                            "pause_ms": workflow_events(bases, since)}
        runs["workflow_edit"] = cli_counts("workflow_edit", counts_dir=WORKFLOW_DIR)

        # run 3: edited again, the canary's fault point armed in the executor
        X = rng.standard_normal((WORKFLOW_ROWS, 3)).astype(np.float32)
        before = mesh_score(owner_base, WORKFLOW_EDITED, X)
        spec = workflow_spec({WORKFLOW_EDITED: 3})
        with WorkflowTraffic(bases, names, rng) as traffic:
            rc, report, wall = workflow_run("workflow_fault", spec, bases, collections, state, traffic,
                                            env={"GORDO_FAULTS": WORKFLOW_FAULT})
        after = mesh_score(owner_base, WORKFLOW_EDITED, X)
        if (rc != 84 or workflow_placement(state) != placement or report["steps"]["canary/fleet"]["status"] != "failed" or not report["rolled_back"]
                or report["promoted"] or report["canary"]["decision"] != "rollback"
                or "FaultInjected" not in report["canary"]["reason"] or set(traffic.statuses) != {200}
                or before[0] != 200 or after != before or served_rev(owner_base, WORKFLOW_EDITED) != 2):
            raise AssertionError(f"workflow fault: exit {rc}, statuses {sorted(set(traffic.statuses))}, bitwise "
                                 f"{after == before}: {json.dumps(report, default=str)[:3000]}")
        readings["fault"] = {"wall_s": wall, "exit": rc, "reason": report["canary"]["reason"],
                             "rolled_back": True, "bitwise": True, "posts": len(traffic.statuses), "non_200": 0,
                             "pause_ms": workflow_events(bases, since)}
        runs["workflow_fault"] = cli_counts("workflow_fault", counts_dir=WORKFLOW_DIR)
    finally:
        for server in servers:
            stop_server(server)
        for log in logs:
            log.close()
    for r, server in enumerate(servers):
        if server.returncode != 0:
            raise AssertionError(f"workflow replica {r} exited {server.returncode} on SIGTERM")
        runs[f"replica_{r}"] = cli_counts(f"workflow_replica_{r}", counts_dir=WORKFLOW_DIR)
    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    total = {k: sum(c[k] for c in runs.values()) for k in runs["replica_0"]}
    readings["wall_s"] = round(time.perf_counter() - t_phase, 3)
    phase("workflow", machines=len(names), replicas=WORKFLOW_REPLICAS, gate=json.dumps(WORKFLOW_GATE),
          launches_by_run=json.dumps(runs),
          **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in readings.items()},
          card=json.dumps(card))
    return total


GAMEDAY_DIR = os.path.join(ROOT, "build", "chip_smoke_gameday")
GAMEDAY_ENV = {"GORDO_SERVER_WARMUP": "1"}  # the replicas' warm-up at start: the server's default
# the latency-judged drills' evidence, printed beside each scenario's wall
GAMEDAY_EVIDENCE = ("burn_peak", "hedge_wins", "interactive_p99_baseline_s", "interactive_p99_flood_s",
                    "interactive_p99_ratio", "shed_precision", "class_burn_peak", "flood_requests")
# the replica child under COUNTED_CLI's counting: its launch counts and
# kernel shapes written as it exits (SIGTERM); a SIGKILLed child writes none
COUNTED_REPLICA = COUNTED_CLI.replace('runpy.run_module("gordo_components_torch.cli"',
                                      'runpy.run_module("gordo_components_torch.gameday.replica"')


def gameday_phase(card: str):
    """``run_gameday`` over the whole catalog on the card: seven scenarios
    on five mesh shapes, every replica a ``gameday/replica.py`` child under
    ``COUNTED_REPLICA`` (the harness's ``_spawn`` swapped for that command
    here), the watchman in this process. Each scenario must pass by its own
    judge and the document be of ``GAMEDAY_SCHEMA``. Returns the
    replicas' launch counts, summed (a SIGKILLed child's are lost)."""
    from gordo_components_torch.gameday import harness

    t_phase = time.perf_counter()
    shutil.rmtree(GAMEDAY_DIR, ignore_errors=True)
    root = os.path.join(GAMEDAY_DIR, "fleet")
    os.makedirs(root)
    spawned, ready = [], []

    def counted_spawn(mesh, index):
        run = f"replica_{len(spawned)}"
        spawned.append(run)
        log = open(os.path.join(GAMEDAY_DIR, f"{run}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", COUNTED_REPLICA, os.path.join(GAMEDAY_DIR, f"{run}.counts.json"),
             "--root", mesh.root, "--port", str(mesh.ports[index]), "--device", mesh.device],
            cwd=ROOT, env=mesh._child_env(index), stdout=log, stderr=subprocess.STDOUT)
        log.close()
        return proc

    real_spawn, real_wait = harness.GamedayMesh._spawn, harness.GamedayMesh.wait_ready

    async def timed_wait(mesh, index, timeout=240.0):
        t = time.perf_counter()
        await real_wait(mesh, index, timeout)
        ready.append(round(time.perf_counter() - t, 3))

    harness.GamedayMesh._spawn, harness.GamedayMesh.wait_ready = counted_spawn, timed_wait
    try:
        # the replicas warm their banks at start, the server's default (the
        # harness turns warm-up off only where the caller left it unset)
        with env_set(GAMEDAY_ENV):
            doc = asyncio.run(harness.run_gameday(root, device=CLI_DEVICE, progress=lambda msg: None))
    finally:
        harness.GamedayMesh._spawn, harness.GamedayMesh.wait_ready = real_spawn, real_wait
    with open(os.path.join(GAMEDAY_DIR, "gameday.json"), "w") as f:
        json.dump(doc, f, indent=1, default=str)
    want = [n for shape in harness.SHAPE_ORDER for n in harness.SCENARIOS if harness.SCENARIOS[n].mesh == shape]
    failed = {n: v["failures"] for n, v in doc["scenarios"].items() if not v["passed"]}
    scenarios = {n: {"wall_s": v["wall_seconds"], "detection_s": v.get("detection_latency_s"),
                     "non_200": v.get("non_200"), "recovery_s": v.get("recovery_s"),
                     "single_core": v.get("single_core"),
                     **{k: v[k] for k in GAMEDAY_EVIDENCE if k in v}} for n, v in doc["scenarios"].items()}
    if doc["schema"] != harness.GAMEDAY_SCHEMA or list(doc["scenarios"]) != want or failed or not doc["passed"]:
        print(harness.render_verdict_table(doc), file=sys.stderr)
        raise AssertionError(f"gameday: {json.dumps(failed, default=str)[:3000]} "
                             f"{json.dumps(scenarios, default=str)[:2000]}")
    runs = {run: cli_counts(run, counts_dir=GAMEDAY_DIR) for run in spawned
            if os.path.exists(os.path.join(GAMEDAY_DIR, f"{run}.counts.json"))}
    shutil.rmtree(GAMEDAY_DIR, ignore_errors=True)
    total = {k: sum(c[k] for c in runs.values()) for k in next(iter(runs.values()))}
    if total["banked_anomaly_score"] <= 0:
        raise AssertionError(f"gameday: the replicas launched {runs}")
    phase("gameday", scenarios=len(doc["scenarios"]), passed=True, schema=doc["schema"], env=json.dumps(GAMEDAY_ENV),
          cpu_count=doc["cpu_count"], single_core=doc["single_core"], by_scenario=json.dumps(scenarios),
          replicas_spawned=len(spawned), replicas_counted=len(runs), replicas_ready_s=json.dumps(ready),
          launches_by_run=json.dumps(runs), wall_s=round(time.perf_counter() - t_phase, 3),
          card=json.dumps(card))
    return total


# (path, kernel): the kernels each path must launch in its own run
PATH_KERNELS = (
    ("seq_train", "lstm_layer"), ("seq_fleet", "lstm_layer"),
    ("zoo_train", "fused_anomaly_score"), ("zoo_fleet", "banked_anomaly_score"),
    ("zoo_bank", "banked_anomaly_score"),
    ("http", "banked_anomaly_score"), ("http", "fused_anomaly_score"),
    ("build", "banked_anomaly_score"), ("build", "fused_anomaly_score"),
    ("build", "lstm_layer"), ("cli", "banked_anomaly_score"), ("cli", "lstm_layer"),
    ("cv", "lstm_layer"), ("collection", "fused_anomaly_score"),
    ("collection", "banked_anomaly_score"), ("collection", "lstm_layer"),
    ("lake", "banked_anomaly_score"), ("lake", "lstm_layer"),
    ("definitions", "banked_anomaly_score"), ("definitions", "fused_anomaly_score"),
    ("observe", "banked_anomaly_score"), ("observe", "fused_anomaly_score"),
    ("observe", "lstm_layer"),
    ("pipeline", "banked_anomaly_score"), ("pipeline", "fused_anomaly_score"),
    ("pipeline", "lstm_layer"), ("pipeline", "lstm_layer_bf16"),
    ("qos", "banked_anomaly_score"), ("qos", "lstm_layer"),
    ("wire", "banked_anomaly_score"), ("wire", "lstm_layer"),
    ("wire", "fused_anomaly_score"),
    ("client", "banked_anomaly_score"), ("client", "lstm_layer"),
    ("client", "fused_anomaly_score"),
    ("resilience", "lstm_layer"), ("resilience", "banked_anomaly_score"),
    ("resilience", "fused_anomaly_score"),
    ("quantized", "banked_anomaly_score"), ("quantized", "lstm_layer"),
    ("quantized", "lstm_layer_bf16"),
    ("stream", "banked_anomaly_score"), ("stream", "fused_anomaly_score"),
    ("stream", "lstm_layer"),
    ("gang", "lstm_layer"), ("gang", "banked_anomaly_score"),
    ("replay", "banked_anomaly_score"),
    ("watchman", "banked_anomaly_score"), ("watchman", "lstm_layer"),
    ("placement", "banked_anomaly_score"), ("placement", "lstm_layer"),
    ("mesh", "banked_anomaly_score"), ("mesh", "lstm_layer"),
    ("workflow", "banked_anomaly_score"), ("workflow", "lstm_layer"),
    ("gameday", "banked_anomaly_score"),
    ("bf16_train", "lstm_layer_bf16"),
    ("bf16_train", "fused_anomaly_score"), ("bf16_bank", "lstm_layer_bf16"),
    ("bf16_bank", "banked_anomaly_score"), ("bf16_bank", "fused_anomaly_score"),
)


def steps(card: str) -> list:
    """The main paths and checks in order, as (name, kind, function,
    arguments): ``path`` counts its launches in this process, ``sub`` in
    the subprocesses it runs (returned), ``check`` is timed alone."""
    return [
        ("train", "path", train_phase, (card,)),
        ("train_parity", "check", train_parity_phase, ()),
        ("seq_train", "path", seq_train_phase, (card,)),
        ("seq_fleet", "path", seq_fleet_phase, (card,)),
        ("seq_train_parity", "check", seq_train_parity_phase, ()),
        ("zoo_train", "path", zoo_train_phase, (card,)),
        ("zoo_fleet", "path", zoo_fleet_phase, (card,)),
        ("zoo_parity", "check", zoo_parity_phase, ()),
        ("bf16_train", "path", bf16_train_phase, (card,)),
        ("bf16_parity", "check", bf16_parity_phase, ()),
        ("http", "path", http_phase, ()),
        ("bank", "path", bank_phase, (card,)),
        ("lstm", "path", bank_phase, (card, "lstm")),
        ("zoo_bank", "path", bank_phase, (card, "conv")),
        ("bf16_bank", "path", bf16_bank_phase, (card,)),
        ("build", "path", build_phase, ()),
        ("cli", "sub", cli_phase, ()),
        ("cv", "path", cv_phase, (card,)),
        ("cv_parity", "check", cv_parity_phase, ()),
        ("collection", "path", collection_phase, (card,)),
        ("lake", "sub", lake_phase, (card,)),
        ("definitions", "sub", definitions_phase, (card,)),
        ("observe", "path", observe_phase, (card,)),
        ("pipeline", "path", pipeline_phase, (card,)),
        ("qos", "path", qos_phase, (card,)),
        ("wire", "path", wire_phase, (card,)),
        ("client", "path", client_phase, (card,)),
        ("resilience", "sub", resilience_phase, (card,)),
        ("quantized", "path", quantized_phase, (card,)),
        ("stream", "path", stream_phase, (card,)),
        ("gang", "path", gang_phase, (card,)),
        ("replay", "path", replay_phase, (card,)),
        ("watchman", "sub", watchman_phase, (card,)),
        ("placement", "path", placement_phase, (card,)),
        ("mesh", "sub", mesh_phase, (card,)),
        ("workflow", "sub", workflow_phase, (card,)),
        ("gameday", "sub", gameday_phase, (card,)),
    ]


# the paths that two more processes of a whole run drive (main), each lane
# its paths one after another beside the first process's: paths that judge
# no latency, about a third of the run's wall each (PERF.md §6). The lanes
# are joined before LANE_JOIN.
LANES = (
    ("cli", "cv", "cv_parity", "collection", "lake", "definitions", "resilience", "watchman"),
    ("observe", "pipeline", "qos", "wire", "client", "quantized", "stream", "gang", "replay", "placement", "mesh"),
)
LANE_JOIN = "workflow"
LANE_TIMEOUT_S = 900  # a lane's whole wall at most
LANE_DIR = os.path.join(ROOT, "build", "chip_smoke_lane")
LANE_COMMAND = [sys.executable, os.path.abspath(__file__)]


def start_lane(index: int, names) -> tuple:
    """A process of this script driving the paths ``names`` in a session of
    its own (its output to files under LANE_DIR); (process, result path,
    its directory)."""
    root = os.path.join(LANE_DIR, str(index))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = os.path.join(root, "lane.json")
    with open(os.path.join(root, "stdout.log"), "w") as so, open(os.path.join(root, "stderr.log"), "w") as se:
        proc = subprocess.Popen([*LANE_COMMAND, "--lane", out, *names], cwd=ROOT, stdout=so, stderr=se,
                                start_new_session=True, preexec_fn=_end_with_parent)
    return proc, out, root


def _end_with_parent() -> None:
    """In a lane before it starts: SIGTERM it if this process dies
    (PR_SET_PDEATHSIG), so that it stops what it started."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)


def stop_lane(proc) -> None:
    """SIGTERM a lane (its phases stop their servers as they unwind); kill
    its session if it has not ended in a minute."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def join_lane(proc, out: str, root: str, deadline: float) -> dict:
    """Wait for a lane until ``deadline`` (perf_counter); print its phase
    lines (and its log to stderr); its result: each path's counts, each
    step's wall, its kernel shapes (joined to PATH_SHAPES here)."""
    try:
        rc = proc.wait(max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        stop_lane(proc)
        rc = None
    with open(os.path.join(root, "stdout.log")) as f:
        sys.stdout.write(f.read())
    with open(os.path.join(root, "stderr.log")) as f:
        sys.stderr.write(f.read())
    sys.stdout.flush()
    sys.stderr.flush()
    if rc != 0:
        raise AssertionError(f"the lane {' '.join(proc.args[4:])} " +
                             (f"ran past {LANE_TIMEOUT_S} s" if rc is None else f"exited {rc}"))
    with open(out) as f:
        result = json.load(f)
    for name, shapes in result["shapes"].items():
        PATH_SHAPES[name].update(tuple(shape) for shape in shapes)
    shutil.rmtree(root, ignore_errors=True)
    return result


def run_step(name, kind, fn, args, paths: dict, walls: dict) -> None:
    """One step: the launch counters from 0 just before it, read just after
    (a path run in subprocesses returns theirs, each from 0 at its start)."""
    score.reset_launch_counts()
    seq_scan.reset_launch_counts()
    t = time.perf_counter()
    result = fn(*args)
    walls[name] = round(time.perf_counter() - t, 1)
    if kind != "check":
        paths[name] = result if kind == "sub" else dict(score.launch_counts, **seq_scan.launch_counts)


def main(names=()) -> int:
    names = list(names)
    lane_out = None
    if names[:1] == ["--lane"]:  # the second process of a whole run
        lane_out, names = names[1], names[2:]
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a card", file=sys.stderr)
        return 2
    card = card_line()
    known = [name for name, *_ in steps(card)]
    if set(names) - set(known):
        print(f"chip_smoke: unknown phases {sorted(set(names) - set(known))}; known: {' '.join(known)}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if lane_out is None:
        phase("card", torch=torch.__version__, cuda=torch.version.cuda,
              device=json.dumps(torch.cuda.get_device_name(0)), nvidia_smi=json.dumps(card))
        libs = _cuda.build_all()
        phase("build", seconds=round(time.perf_counter() - t0, 3),
              libraries=",".join(sorted(libs)), flags=json.dumps(" ".join(_cuda.NVCC_FLAGS)),
              kernels_max_regs_max_local_bytes=json.dumps(resource_usage(libs)))
    else:
        _cuda.build_all()  # built by the first process: loads only

    kernels = {}
    if not names:
        kernels = kernel_phase()
        kernels.update(lstm_kernel_phase())
        kernels.update(bf16_kernel_phase())

    paths = {}
    # each phase's wall seconds (the lane's own from its first path on)
    walls = {"kernels": round(time.perf_counter() - t0, 1)} if lane_out is None else {}
    record_path_shapes()
    lanes = [start_lane(i, lane) for i, lane in enumerate(LANES)] if not names else []
    in_lanes = {name for lane in LANES for name in lane} if lanes else set()
    deadline = time.perf_counter() + LANE_TIMEOUT_S

    def join():
        t = time.perf_counter()
        while lanes:
            result = join_lane(*lanes[0], deadline)
            walls[f"lane{len(LANES) - len(lanes)}_s"] = result["walls"].pop("lane_s")
            lanes.pop(0)
            paths.update(result["paths"])
            walls.update(result["walls"])
        walls["lane_wait"] = round(time.perf_counter() - t, 1)

    try:
        for name, kind, fn, args in steps(card):
            if names and name not in names or name in in_lanes:
                continue
            if name == LANE_JOIN and lanes:
                join()
            run_step(name, kind, fn, args, paths, walls)
        if lanes:
            join()
    finally:
        for proc, *_ in lanes:
            stop_lane(proc)
    if lane_out is not None:
        walls["lane_s"] = round(time.perf_counter() - t0, 1)
        with open(lane_out, "w") as f:
            json.dump({"paths": paths, "walls": walls,
                       "shapes": {k: sorted(v) for k, v in PATH_SHAPES.items()}}, f)
        return 0
    if not names:
        t = time.perf_counter()
        path_parity_phase(kernels)
        walls["path_parity"] = round(time.perf_counter() - t, 1)
    for path, kernel in PATH_KERNELS:
        if path in paths and paths[path][kernel] <= 0:
            raise AssertionError(f"{path}: launched no {kernel}")
    phase("counts", **{f"{path}.{k}": v for path, c in paths.items() for k, v in c.items()})
    phase("walls", total_s=round(time.perf_counter() - t0, 1), **walls)
    for name in kernels:
        n = sum(c[name] for c in paths.values())
        if n <= 0:
            raise AssertionError(f"{name}: the main path launched its kernel {n} times")
        kernels[name]["launches"] = n

    if kernels:
        print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
