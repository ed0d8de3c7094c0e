#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version, serve a full-width transformer
TextClassifier through ``InferenceModel``, train it through
``compile``/``fit``/``evaluate``, and show that both paths went through
the kernels; then the recommenders, int8, the recurrent TextClassifier,
Seq2seq's generative serving, the session recommender, ResNet-50, the
flash kernels on bfloat16 through the port's ``bench_attention``,
model persistence: checkpointed training resumed and retried,
``save_model`` files loaded and served, the Keras transformer models:
GPT-1 served and trained, BERT-base fine-tuned through the TFPark
estimators, a BERT checkpoint loaded, the rest of the Keras surface:
AnomalyDetector trained and served, the 64 layer classes of that slice
and the regularizers held to the CPU, and KNRM trained and ranked, MoE,
ConvLSTM, remat, freezing and optimizer groups, keras2 and autograd, the
compiled path (CUDA-graph capture) against the eager one, and the data
pipeline and offline batch scoring: BERT-base trained on a resumable
``DataPipeline`` and scored by a fleet of worker processes, and images
in: JPEG records served through Cluster Serving, SSD-300 object detection
served and trained, and NNFrames' ``NNClassifier`` on Wide & Deep, and
models from other frameworks: Inception-v1 converted from tf.keras and
trained through TFPark, ResNet-50 imported from ONNX, TorchNet, the Wide &
Deep bench and a GAN, and the local trainer and the serving fleet:
``LocalEstimator`` on BERT-base, the training watchdog's halt drill, and
an autoscaled, supervised fleet of BERT-base replicas stormed by the
open-loop load generator, with the offline tools over its run dir, and
multi-GPU: BERT-base trained through ``launch_cli`` on an NCCL world of
one and on two gloo ranks of the one card under data, FSDP and tensor
parallelism.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. build every kernel from ``analytics_zoo_torch/csrc`` (one nvcc per
   source, all started together) and print the card's name and power
   limit;
2. each kernel against its plain version at the shapes its path gives
   it, without TF32, with its time (median of CUDA-event-timed
   launches), the plain version's time, a library call's time where one
   PyTorch call computes the same function, and the least time the card
   could take for the same work: flash forward, dQ and dK/dV at
   (8, 12, 512, 64), bias→GeLU, LayerNorm→GeLU (with
   ``torch.nn.functional.layer_norm`` beside it at (4096, 768) with no
   activation, and its fixed cost at (1, 4)), Adam and SGD on the embedding's 23,440,896-element leaf and a
   small odd one (a one-leaf table through the multi-tensor kernels); the
   flash kernels are also checked at (2, 4, 200, 64)
   and (2, 4, 512, 128), causal and not, and each twice to show two
   launches bit-identical;
3. ``TextClassifier(encoder="transformer")`` at BERT-base widths
   (hidden 768, 12 heads of 64, FFN 3072, 512 positions, vocabulary
   30522, 12 blocks) with seeded random weights, served through
   ``InferenceModel.load_zoo``/``predict``: 4 requests of 8 sequences,
   launch counts checked, one request re-run under ``ops.fused=torch``
   and compared;
3b. the same ``InferenceModel`` behind Cluster Serving's front end:
   ``ClusterServing`` reading the Redis stream of a ``BrokerServer``
   over TCP (batch 8, buckets 1/2/4/8, top 5, a consumer group) with
   its HTTP fast path; ``warm_start`` warms the 4 buckets, then 64
   seeded token records enqueued through ``InputQueue`` and 8 singles
   through ``ServingHttpClient.predict_http`` are served while the loop
   runs in the background; every record answered once, no dead letter,
   launches 12/12/1 per served batch (batches counted from the
   executor's ``serving_execute`` spans), results against
   ``ops.fused=torch``, records/s, arrival→result p50/p99, batches by
   bucket and the front end's host time per record;
4. the same model trained: ``compile(Adam(lr=1e-4),
   "sparse_categorical_crossentropy_with_logits", metrics=["accuracy"])``,
   ``fit`` on 64 seeded sequences (batch 8, one epoch: 8 steps) with the
   launch counts checked per step (one Adam launch a step for all 154
   leaves), then ``evaluate``; the multi-tensor Adam and SGD updates on
   copies of the 154 leaves against their plain versions leaf by leaf
   (bit-identical) and timed: the kernel, the step's whole fused update
   and ``torch.optim.Adam``/``SGD(fused=True).step`` in turns, the plain
   version, the bound, the update's host time, and a ``torch.profiler``
   count of the device kernels of one whole Adam and one whole SGD
   update (one each); the step time in turns under
   ``ops.fused=torch`` and ``auto``;
5. one step's gradients by the kernels against the plain versions
   (``ops.fused=torch``), same weights, same batch, same dropout
   generators, leaf by leaf, with float32 and with bf16 products;
6. two ``fit`` steps with ``SGD(momentum=0.9)``, launch counts checked
   (one SGD launch a step);
7. NeuralCF at the JAX bench's ML-1M width (``bench.py`` ``bench_ncf``:
   6040 users, 3706 items, embeddings 64, hidden 128/64/32, seeded
   random weights) on ``synthetic_ratings()`` with 4 negatives a
   positive: ``compile(Adam(lr=1e-3), ..., metrics=[HitRatio(10, 100),
   NDCG(10, 100)])``, ``fit`` one epoch at batch 16384 (one Adam launch a
   step for its 12 leaves), the step time of ``train_step_at`` under
   ``prefetch`` in turns under ``ops.fused=auto`` and ``torch`` and the
   loss after the same steps under each, ``evaluate`` HitRatio@10/NDCG@10
   on the 6040 x 101 leave-one-out rows (checked against the same ranks
   taken on the host), ``predict`` against the same forward on the CPU,
   ``recommend_for_user``/``recommend_for_item``, the multi-tensor Adam
   and SGD kernels against their plain versions on each of the 12 leaves
   (bit-identical), and the 12-leaf updates timed as in phase 4;
8. Wide & Deep at the census configuration of the JAX package's
   ``benchmarks/wide_deep.py`` (2^19 seeded rows, hidden 64/32/16):
   ``fit`` two epochs at batch 8192 with ``validation_split=0.1`` and
   ``metrics=["accuracy", "auc"]`` (one Adam launch a step for its 11
   leaves; a ``val`` record each epoch), then ``evaluate`` and the Adam
   and SGD kernels against their plain versions on each of the 11 leaves,
   and the 11-leaf updates timed as in phase 4;
9. ``TextClassifier(encoder="cnn")`` at its default widths (tokens 200,
   sequence 500, 256 filters of width 5, 5000 words; 20 classes),
   loaded through ``InferenceModel.load_zoo(quantize="calibrated")`` and
   predicted on 8 x 500 tokens, held to its plain route
   (``ops.fused=torch``) and timed in turns against float32;
10. ``TextClassifier(encoder="lstm"|"gru")`` at the same defaults (one
   recurrent layer of 256 over 500 steps), seeded weights, served through
   ``InferenceModel``: logits on the card against the same model on the
   CPU under float32 (1e-4) and bf16 products (2e-2), request latency in
   turns with the cnn encoder, launches, device busy time and idle share
   of one request each from ``torch.profiler`` (in a child process,
   ``--profile-recurrent``, with one decode iteration of a full 16-slot
   pool), and weight-only int8 on the lstm against float32;
11. ``Seq2seq`` at ``bench_serving_generative``'s configuration
   (vocabulary 512, embedding 64, one LSTM of 192, 64 requests of 12
   tokens, budgets drawn as there, 16 slots, 32 steps, start 1, stop 2):
   ``infer`` early exit against scan-then-mask, the 64 requests through
   ``ServingEngine.register_generative`` + ``warm`` held to ``infer``'s
   rows under float32 products (up to each row's first top-2 logit margin
   below 1e-3), the scheduler's tokens/s, iterations, inter-token and
   first-token latency and occupancy beside the naive whole-sequence path,
   one streamed ``ServingHttpClient.generate`` and one Redis record with
   ``max_tokens`` through ``ClusterServing``;
12. ``SessionRecommender`` at its defaults over MovieLens-1M's 3706 items:
   ``recommend_for_session`` on 1024 sessions, card against CPU (the same
   top-5 where scores differ by more than 1e-5), ``predict`` timed;
13. image classification at the JAX ResNet bench's configuration
   (``benchmarks/resnet.py``: ResNet-50, 1000 classes, 224x224x3):
   13a ``ImageClassifier("resnet-50")`` served through ``InferenceModel``
   at batch 32, bf16 and float32 products in turns (median latency,
   images/s), card against CPU logits under float32 (relative L2 1e-4) and
   ``predict_image_classes`` through an ``ImageSet`` (center crop, channel
   normalization; top-5 card against CPU); 13b the ``space_to_depth``-stem
   net trained through ``train_step`` at batch 128, bf16 products, the
   bench's SGD (momentum 0.9, warmup then poly) on batches made on the
   card, 3 untimed and 10 timed steps a turn in turns with
   ``ops.fused=torch`` (median, spread, images/s, the step's FLOP count
   from the layers' shapes and its share of the bf16 peak, peak memory),
   one ``fused_sgd`` launch a step, the loss finite and every BN statistic
   moved; 13c a 2-step ``fit`` on host numpy data (launches, moving
   statistics); 13d the Adam and SGD kernels on the 161 leaves against
   their plain versions (bit-identical) and timed as in phase 4; 13e a
   child ``python3 chip_smoke.py --profile-resnet`` profiles one training
   step and one predict (device busy, idle share, device ms by group,
   launches);
14. the flash kernels on bfloat16: forward, dQ and dK/dV against their
   plain versions (which follow the reference's bf16 order of operations)
   at (2, 4, 200, 64), (2, 4, 512, 128), (1, 2, 17, 128) and
   ``bench_attention``'s (4, 8, 4096, 128), causal and not, O, LSE, dQ,
   dK and dV each with its tolerance printed, two launches bit-identical,
   and the forward alone at T = 1, 127, 129 and (1, 2, 4096, 64)
   (``BF16_FWD_SHAPES``), with the check below; at the same shapes, on
   inputs where key 0 leads every row, O equal to the plain version's on
   all but 5% of its elements, a check that S rounded to bf16 first (the
   plain version's former order) and an unrounded P both fail; ``flash_attention``
   through autograd launching only the bf16 kernels on bf16 at head_dim
   64/128, only the float32 ones on float32, and none (the plain result)
   at head_dim 32; each kernel timed at (4, 8, 4096, 128) causal beside its
   bound, its plain version and ``scaled_dot_product_attention`` in bf16
   (forward, backward, forward + backward; the backend PyTorch picked
   printed), and at (4, 8, 8192, 128) without the plain versions, where
   the kernels' outputs on the whole inputs are held against the plain
   versions on three heads' slices; then
   ``benchmarks.attention.bench_attention()`` at its defaults, its dict on
   one line, and its launches, which the ``kernels`` line reports;
15. model persistence at full width, each snapshot's bytes, save and
   restore seconds and MB/s printed: 15a the phase 3/4 model trained with
   ``set_checkpoint`` (64 seeded sequences, batch 8, Adam, 2 epochs),
   then a fresh model's ``fit`` to 3 epochs on the same directory resumes
   at epoch 2, iteration 16, with the launches of phase 4 a step (these
   are the launches the ``kernels`` line reports for the float32
   kernels), held against an uninterrupted 3-epoch run and that run again
   (the control): losses and the 154 leaves bit-identical if the control
   is, else within twice the control's largest difference (these runs
   under ``torch.use_deterministic_algorithms``: the embeddings' backward
   sums with atomics otherwise, see ``deterministic``); 15b one
   ``TransientFault`` (``ChaosPlan`` at the ``trainer.dispatch`` site,
   step 10) in a ``model_dir`` run: one retry, one restore, the end state
   held as in 15a; 15c ``save_model`` of the resumed model, a fresh model
   loaded through ``InferenceModel.load_zoo_file`` serving 4 requests of
   8 x 512 bit-identical to ``load_zoo`` of the model in memory with
   12/12/1 launches a request, float32 and ``quantize=True``; 15d the
   serving CLI's builder (``chip_smoke:bert_base``) with ``weights=`` the
   file, 8 records through phase 3b's ``BrokerServer``/``ClusterServing``
   harness at bucket 8, top-5 classes equal to 15c's; 15e ``Seq2seq`` at
   ``examples/chatbot/seq2seq_example.py``'s configuration (vocabulary 40,
   8 tokens, 4096 dialogues, embedding 48, one LSTM of 96, batch 128,
   Adam(0.01)) resumed and held as in 15a, its ``train_step_at`` median
   and spread, and one step profiled in a child (``--profile-seq2seq-
   train``) beside phase 10's inference profile; 15f the temporary
   directories removed and the phase's seconds printed;
16. the Keras transformer models at full width, seeded random weights:
   16a GPT-1 (``TransformerLayer.init_with_default_embedding``: vocab
   40990 = 40478 tokens + 512 position slots, seq_len 512, 12 blocks of
   768, 12 heads; ``TimeDistributed(Dense(40478))`` over the sequence
   output) served through ``InferenceModel``: 4 requests of 8 x 512,
   position ids ``arange(40478, 40990)``, 12 causal float32 flash
   forward and 12 bias→GeLU launches a request and no other kernel, the
   logits against ``ops.fused=torch`` (≤ 2e-2), latency median and
   spread; 16b the same model trained (``fit`` 8 steps of 8 next-token
   rows, Adam: 12 each of forward, dQ, dK/dV and bias→GeLU and 1 Adam a
   step), one step's gradients against the plain versions with float32
   products (relative L2 ≤ 1e-3 a leaf), step ms in turns with
   ``ops.fused=torch``, peak memory, then the three float32 flash
   kernels at (8, 12, 512, 64) causal checked and timed beside their
   plain versions, their bound (T^2/2 pairs) and
   ``scaled_dot_product_attention``; 16c ``BERTClassifier`` at BERT-Base,
   Uncased's configuration (2 classes) trained 8 steps of 32 x 128 under
   ``AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=8)``: 12
   bias→GeLU launches a step, no flash kernel (its attention mask takes
   dense attention) and no Adam kernel (the fused update declines
   AdamWeightDecay), as the reference routes them, every leaf moved, its
   step ms, ``evaluate`` and ``predict``; ``BERTSQuAD.predict_spans`` on
   12 x 384 and ``BERTNER.predict``, shapes and ms a call; 16d
   ``BERTClassifier(bert_checkpoint=)`` from an HF-named state_dict drawn
   on the card, every encoder leaf bit-identical to its source and a
   second load's predictions bit-identical, then ``TransformerLayer`` at
   ``seq_len=77`` (the port takes the flash kernel, the reference dense
   attention) against ``ops.fused=torch`` with float32 and bf16 products
   (≤ 2e-2);
17. the rest of the Keras surface under float32 products: 17a
   ``AnomalyDetector`` at its default widths (LSTM 8 -> 32 -> 15, dropouts
   0.2, ``Dense(1)``) on the taxi app's synthetic series at the length of
   NAB's ``nyc_taxi.csv`` (10,320 half-hourly points), unrolled by 24 and
   split 80/20 in order: ``compile(Adam(lr=0.01), "mse")``, ``fit`` 3
   epochs at batch 128 with 1 ``fused_adam`` launch a step, the step's
   median and quartiles, ``predict`` at batch 512 (windows/s) and
   ``detect_anomalies`` (the incidents recovered), the card's ``predict``
   against the CPU port's within 1e-5 and a 2-epoch zero-dropout ``fit``
   card against CPU within 1e-4 a loss; 17b each of the 64 layer classes
   of the slice on the card against the CPU (forward and gradients,
   1e-5 scaled by the magnitude above 1), the random layers by their
   training statistics; 17c a regularized ``Sequential`` (Convolution1D,
   LSTM, Dense) 3 Adam steps card against CPU within 1e-5, the history
   losses without the penalty (``python3 chip_smoke.py --keras-surface``
   runs phase 17 alone);
18. text matching and the rest of the Keras API (``python3 chip_smoke.py
   --text-matching`` runs it alone): 18a ``KNRM`` at the qaranker
   example's lengths (10 and 40 tokens), KNRM.scala's 300-wide embedding
   (a seeded 20,001 x 300 matrix, trainable), 21 kernels, on 2,048
   synthetic questions with 1 relevant and 9 irrelevant answers each (the
   example's generator over 20,000 words) through ``TextSet`` and
   ``from_relation_pairs``: ``compile(Adam, "rank_hinge")``, ``fit``
   (``shuffle=False``, batch 256, 3 epochs) with 1 ``fused_adam`` launch a
   step, the step's median and quartiles, pairs/s, ``score_pairs`` rows/s,
   MAP and NDCG@3 before and after training, card against CPU
   ``score_pairs`` on the trained weights (1e-5); 18b ``MoE`` at
   Switch-Base's widths (768, 3072, 8 experts, top-1, capacity factor
   1.25) on 8 x 512 tokens, 4 Adam steps of ``call_with_aux`` under mse +
   1e-2 aux (ms, tokens dropped, aux), card against CPU output and aux,
   and top-2 with an overflow at a small width; 18c a ``ConvLSTM2D`` stack
   of 128, 64 and 64 filters, 5 x 5, on 16 x 10 frames of 16 x 16 x 16
   (Shi et al. 2015's Moving-MNIST patches): forward and backward ms,
   card against CPU, and ``ConvLSTM3D`` small; 18a-c under float32
   products; 18d at BERT-base width (phase 4's model, 8 x 512, Adam):
   ``train.remat`` off and on in turns, 4 steps each under deterministic
   algorithms, step ms, peak memory and launches, the params bit-identical;
   ``freeze_up_to`` the encoder, then ``fit`` on the fused Adam with the
   frozen leaves bit-identical; two optimizer groups (Adam on the head,
   SGD on ``"*"``) with no optimizer kernel, one step card against CPU;
   18e a ``keras2`` Conv2D/MaxPooling2D/Dense ``Sequential`` fit on
   ``datasets.mnist``'s synthetic digits, and ``custom_loss_example.py``'s
   ``autograd.CustomLoss`` in ``compile``;
19. compile and warm start (``python3 chip_smoke.py --compile`` runs it
   alone; every earlier phase runs under ``compile.aot=true``, the
   default, and prints its captured programs and capture fallbacks): 19a
   phase 4's BERT-base ``fit`` (64 seeded sequences, batch 8, Adam,
   dropout on) captured and eager under deterministic algorithms, params
   and ``history`` bit-identical, 12/12/12/12/1/1 launches a step on both,
   no capture fallback, then ``train_step_at`` ms in turns, capture
   seconds and pool bytes; 19b the same width served through
   ``InferenceModel``: ``warm`` captures buckets 1/2/4/8 x 512, 4 requests
   of 8 bit-identical to the eager route, request ms in turns, then phase
   3b's Cluster Serving traffic on both routes (records/s, arrival→result
   p50/p99); 19c NeuralCF at ``bench_ncf``'s width, 2 epochs on the HBM
   epoch cache, chunked (``hbm_cache_mb=0``), per-step captured and
   per-step eager routes (``steps_per_dispatch=1``, ``compile.aot`` on
   and off) under deterministic algorithms: params bit-identical, each
   epoch loss
   its route's rule, ms a step and samples/s, the bytes ``put_batch``
   and ``put_whole`` moved (the HBM route: the dataset once); 19d phase 11's ``Seq2seq``
   pool (16 slots, 64 requests) captured at every rung against the eager
   pool, tokens held to ``infer``'s, tokens/s and inter-token p50/p99;
   19e a cold build fills a cache directory, a child process with an
   empty build directory loads every kernel library from it starting no
   ``nvcc`` process, then a corrupted entry is a loud miss, rebuilt, its kernels
   identical in SASS;
20. the data pipeline and offline batch scoring (``python3 chip_smoke.py
   --data-pipeline`` runs it alone): 20a phase 4's BERT-base trained on a
   ``DataPipeline`` over an ``NpyDirSource`` of 256 seeded rows of 512
   tokens (batch 8, shuffled, 2 workers, ``data.prefetch`` 2, Adam, 2
   epochs, ``Estimator(model_dir=)`` snapshotting every 12 iterations)
   under deterministic algorithms: a run stopped by a fault at the
   ``data.batch`` site mid-epoch and resumed from its snapshot, held bit
   for bit to the uninterrupted run (params, ``history``, the resumed first
   batch) as phase 15 holds, 12/12/12/12/1/1 launches a step; then one
   epoch's step ms on the pipeline route in turns with the ``FeatureSet``
   per-step route, and the host's wait for a batch; 20b
   ``bench_input_pipeline`` at its defaults (4096 x 32x32x3 float32, batch
   128): samples/s bare, with a normalize stage single-threaded and in a
   pool, and through the ``DeviceLoader`` to the card; 20c
   ``bench_batch_scoring`` at its defaults (the demo job: 4096 rows, 512 a
   shard, batch 128, 2 worker processes), a control and a drill killing
   worker 0 at ``worker.step`` 1: rows/s/chip, chips for the deadline,
   resume overhead, rows recomputed, restarts, duplicate commits (0); 20d
   the batch fleet scoring phase 3's BERT-base (a ``save_model`` file,
   built in each worker by ``chip_smoke.py:fleet_bert``) on 2048 rows of
   512 tokens, 256 a shard, batch 32, 2 workers on the card, a control and
   a kill drill: outputs byte-identical to each other and to an in-process
   ``InferenceModel.predict`` at batch 32, less than a shard recomputed, no
   duplicate commit, each worker's ``warm`` captured, the replacement
   incarnation loading the kernel libraries from the run dir's compile
   farm without ``nvcc``; rows/s/chip beside in-process predict, worker
   start-up s cold and replacement, ``chips_for``; one ``BatchWorker`` in
   process on a 256-row ledger with 12/12/1 launches a batch;
21. images in (``python3 chip_smoke.py --images`` runs it alone), each
   figure beside the card's name and power limit: 21a ``bench_serving``'s
   workload through the port (ResNet-18 at 64x64x3 and 1000 classes,
   seeded weights, 2048 JPEG records from ``RandomState(0)``, batch 32,
   top 5, on an ``EmbeddedBroker``): the codec that decoded, sequential
   and pipelined records/s, latency p50/p95/p99 and the calibrated-int8
   pass's records/s; every served top 5 held to ``predict`` on the same
   decoded BGR arrays, and a poison record answered with an error while
   the records after it are served; 21b ``ObjectDetector("ssd_vgg300",
   num_classes=21)`` (BN-VGG at Liu et al.'s widths, seeded weights at
   He's gain, the default policy): ``detect`` at batch 32 captured and
   eager in turns (ms a batch, images/s, capture seconds, the two routes
   bit-identical), and card against CPU on two images with float32
   products (boxes and probabilities before NMS within 1e-4, detections
   equal where neighbouring scores are more than 1e-3 apart); 21c
   MultiBox loss ``train_step``s at batch 32 and 16 boxes under Adam (step
   ms, peak memory, one ``fused_adam`` a step; the kernel held and timed
   at SSD-300's leaves), then a VOC tree written from a seed through
   ``read_voc >> DetHFlip >> DetResize >> DetNormalize >> to_feature_set``
   trains ``ssd_lite`` at 64x64 until its mAP beats the untrained
   model's; 21d ``NNClassifier`` on ``benchmarks/wide_deep.py``'s Wide &
   Deep and data at 2^16 rows (batch 8192, one epoch, ``Adam(1e-3)``, a
   pandas frame): one ``fused_adam`` a step, a saved and reloaded
   ``NNClassifierModel`` predicting the same, the Adam kernel held and
   timed at its leaves (22d measures the bench's fit and ``transform``);
22. models from other frameworks (``python3 chip_smoke.py --interop``
   runs it alone), each figure beside the card's name and power limit:
   22a Inception-v1 (BASELINE config 4) through TFPark's ``KerasModel``
   from a stand-in for the tf.keras model (``KerasStandIn``: the
   committed ``benchmarks/inception_v1.json``, layer classes named as
   Keras's, weights from seed 0), measured by the port's
   ``run_inception_bench`` at its defaults (512 rows of 224x224x3, batch
   64, 1 warm and 3 timed epochs; convert s, imgs/s an epoch, fit wall
   s, peak memory, one ``fused_sgd`` a step at momentum 0 as the
   reference maps tf.keras SGD), the eval forward of 4 images card
   against CPU on the same converted weights (float32 products, within
   1e-4 of the largest probability), a ``TFOptimizer.from_keras``
   ``optimize`` of 2 iterations on a ``TFDataset``, and the SGD kernel
   held and timed at its leaves; 22b ResNet-50 v1 written as ONNX with
   the port's codec (resnet50-v1-7's op set, seeded weights), imported
   by ``Net.load_onnx(bytes)``, served by ``InferenceModel.load_zoo`` at
   batch 32 captured and eager in turns, held to the CPU (relative L2
   1e-4, float32 products) and trained 5 Adam ``train_step``s at batch
   32 (one ``fused_adam`` a step; the kernel held and timed at its
   leaves); 22c a ResNet-18 ``nn.Module`` served by
   ``InferenceModel.load_torch`` at batch 32, its logits held to the
   module's own forward on the card (relative L2 1e-4), its training
   refused (BatchNorm's integer leaf, ROADMAP queue 3 fault (b)), and a
   BatchNorm-free convnet ``TorchNet`` trained 20 Adam steps with a
   ``TorchCriterion(MSELoss)``; 22d the port's ``run_wide_deep_bench`` at
   its defaults; 22e ``GANEstimator``: the first D step card against CPU
   on the same noise (SGD, float32 products, 1e-5), 20 alternating Adam
   steps, and a line naming the parts not run for want of TensorFlow;
23. the local trainer and the serving fleet (``python3 chip_smoke.py
   --fleet`` runs it alone), each figure beside the card's name and
   power limit: 23a ``LocalEstimator`` on phase 2's BERT-base
   ``TextClassifier`` (8 x 512, Adam, the default policy): 8 steps
   through ``fit`` (12 launches of each float32 flash kernel and of
   bias->GeLU, 1 LayerNorm->GeLU and no ``fused_adam`` a step: the
   optimizer's own update), ``evaluate``, ``predict``, the median of 10
   captured steps, and 2 steps card against CPU under the float32 policy
   (losses within 1e-4, params within 1e-5 of their largest magnitude);
   23b the watchdog drill: phase 17's AnomalyDetector trained through the
   ``Estimator`` under ``checkpoint_and_halt`` on targets NaN in the last
   10 rows, on the captured per-step route and the eager one (each halts
   between the first poisoned step and the epoch's loss read, the
   snapshot in ``<model_dir>/halt/``), a fresh ``Estimator`` resuming the
   halt snapshot under ``warn``, ``LocalEstimator`` halting on the same
   data, and the Adam kernel held and timed at the model's leaves; 23c a
   ``ServingSupervisor`` fleet (1 to 2 replicas, each
   ``cli_worker_factory``'s ``serving.cli start`` serving the BERT-base
   ``TextClassifier`` from one ``save_model`` file, a TCP
   ``BrokerServer``, a run dir) stormed by ``flash_burst_with_outage`` at
   20 records/s and a 10x burst as long as the replicas' measured
   start-up allows (20 s at least), a real broker outage and replica 0
   SIGKILLed mid-burst: the verdict (p99 from the scheduled time beside
   the sent basis, exactly-once, the autoscaler's lag, no flapping), the
   capacity report, the replica trajectory, the restarts, each
   incarnation's spawn to its first ``/healthz`` 200; every ok result and
   8 seeded distinct rows against in-process ``predict``; the SIGTERM
   drain (exit 0, nothing pending); 23d the aggregator, ``merge_traces``,
   ``merge_requests``, the SLO timeline of ``slo.yaml``, ``drift_report``
   and ``diagnose`` over the run dir (the broker outage ranked with its
   breaker-open citations); 23e ``quick_start --smoke`` on the card;
24. multi-GPU on the one card (``python3 chip_smoke.py --multi-gpu`` runs
   it alone): 24a ``launch_cli -n 1`` starts a child that joins an NCCL
   process group of one and runs ``Estimator.train`` for 8 Adam steps of
   phase 3's BERT-base ``TextClassifier`` (8 x 512) on the mesh
   ``{"data": 1}``: launches 12/12/12/12/1 and one ``fused_adam`` a step,
   every param bit-identical to the same steps taken in this process with
   no process group (deterministic algorithms on both); 24b ``launch_cli
   -n 2`` starts two ranks on the card over gloo with CUDA tensors, each
   taking 2 SGD steps (float32 products) under ``{"data": 2}`` (4 rows
   each), ``{"fsdp": 2}`` and ``{"model": 2}`` (the flash kernels on 6
   heads): the ranks' gathered params bit-identical after every step
   (SHA-256), within 1e-5 of their magnitude of one device's steps over
   the same 8 rows, per-rank launches, step times and the gradient sync's
   time, and which collectives gloo carried on the card's tensors and
   which it staged through the host; NCCL between cards, the ring's and
   the pipeline's sends and MoE's all_to_all wait for a machine with more
   than one card;
25. a ``kernels`` JSON line (the float32 forward and backward kernels'
   and Adam's launches from 24a, SGD's from 24b rank 0, Adam's times at
   23b's leaves, SGD's times from 22a), then the device line last.

The int8 phases besides 9: 2b holds ``quantized_matmul`` and
``quantized_conv`` (``torch._int_mm``, a convolution as one product over
its unfolded input) against their plain routes on the card, bit for bit,
at the int8 paths' shapes (BERT-base's head Dense (8, 768) -> 256,
NeuralCF's three quantized Denses at 8192 rows, a one-row batch, the cnn
encoder's Convolution1D, a strided SAME Convolution2D), each timed beside
its plain route and the bf16 product; 3c serves the phase 3 model
weight-only int8 (``load_zoo(quantize=True)``): 4 requests with the
three forward kernels' launches checked, the logits against the same
int8 model under ``ops.fused=torch`` (≤ 2e-2) and against the float32
model (reported), the parameters' device memory and the dequantization's
time, then phase 3b's Cluster Serving traffic on it; 7b calibrates the
trained NeuralCF as the JAX ``kernels`` bench does (4 x 1024 rows),
predicts 65536 rows at batch 8192 under float32 and int8 weights in turns
(rows/s), holds the JAX package's int8 bars (softmax difference < 2e-2,
class agreement ≥ 0.97) and evaluates HitRatio@10/NDCG@10 of both.

Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12       # dense, tensor cores

WARMUP = 3
TIMED = 25

# The flash kernels take every product on the tensor cores in split TF32:
# each operand x = hi + lo, both TF32, and each product as lo.hi + hi.lo +
# hi.hi with float32 accumulation, which drops ~2^-22 of each product
# term, and they sum in 8-term steps in another order than the plain
# versions' full-length float32 products: ~1e-6 relative of a result or
# less.  The forward's O is a convex combination of rows of V and its LSE
# a log of a sum of positive terms, so neither cancels: 1e-5 holds them
# (7.3e-6 at most measured on the H100); the backward's
# dS = P (dP - delta) cancels, and its results take 1e-4.
FWD_ATOL, FWD_RTOL = 1e-5, 1e-5
FWD_LSE_ATOL = 1e-5
BWD_ATOL, BWD_RTOL = 1e-4, 1e-4
# where the flash kernels are checked: the training shape, the JAX
# TextClassifier's default token_length (200, a ragged last tile), and
# head_dim 128
FLASH_SHAPES = ((8, 12, 512, 64), (2, 4, 200, 64), (2, 4, 512, 128))
# The optimizer kernels block FMA contraction and repeat the plain
# version's elementwise ops: bit-identical.
OPT_ATOL = 0.0
# Gradients under ops.fused=auto against ops.fused=torch, relative L2 per
# leaf, one step, same weights, batch and dropout masks.  With float32
# products (dtype.compute=float32) the routes differ by the flash kernels'
# split-TF32 products and their order of summation, and by the LayerNorm
# kernel's (~1e-6 relative of a result): GRAD_RTOL_F32.  Under the
# default policy every product rounds its operands to bf16 on both
# routes; a value the summation order moves across a bf16 rounding
# boundary moves by 2^-8, and the global
# max-pool then routes some channels' gradient to another token, so whole
# gradient contributions move: measured 6.9e-2 median, 1.1e-1 max on the
# H100; GRAD_RTOL_BF16 bounds that and still catches a wrong gradient
# (relative error ~1 and above).
GRAD_RTOL_F32 = 1e-3
GRAD_RTOL_BF16 = 0.25
EMBED_LEAF = 30522 * 768          # the embedding table: not a multiple of 1024
SMALL_LEAF = 1001

# Whole-model tolerance between ops.fused=auto (kernels) and
# ops.fused=torch (plain versions) logits, same weights and inputs.  The
# bf16 rounding of each product's operands is the same code on both
# sides; attention differs by the flash forward's split-TF32 products and
# order of summation, LayerNorm and the epilogues by their order of
# summation (~1e-6 relative in f32 or less); where such a difference moves
# a value across a bf16 rounding boundary, that one operand moves by 2^-8
# relative and carries through the following layers.
MODEL_ATOL = 2e-2
# Cluster Serving's top-N probabilities against the plain versions'
# softmax of the same record: a logit difference of at most MODEL_ATOL
# moves a softmax probability by at most MODEL_ATOL / 2
PROB_ATOL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median of TIMED launches, each between two CUDA events.

    The device first spins for ~50 ms so that the host queues every
    launch and event before the device reaches them: the events then
    bracket device time, not the wrapper's Python work (which would
    otherwise dominate kernels of a few microseconds)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(TIMED):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(bytes_moved: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(bytes_moved: float, flops: float):
    """The flash kernels' bound: their float32 products taken as split TF32,
    three tensor-core products each (the backward does so; the forward is
    held to the same rule)."""
    return bound_ms(bytes_moved, 3 * flops, TF32_FLOPS_PER_S)


def close(name, got, want, atol, rtol=0.0) -> float:
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_abs = float(err.max())
    if not (worst <= atol):
        fail(f"{name}: max abs err {max_abs:.3e} over tolerance "
             f"(atol {atol}, rtol {rtol})")
    return max_abs


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def serve_front_end(torch, im, fail, broker_url=None, n_singles=8,
                    queued_first=False, n_stream=64, buckets=(1, 2, 4, 8)):
    """Serve ``n_stream`` seeded token records (the first of the same 64)
    through the Redis stream over TCP and ``n_singles`` through the HTTP
    fast path with ``ClusterServing`` over ``im`` (batch 8, ``buckets``,
    top 5, a consumer group), as
    ``python -m analytics_zoo_torch.serving.cli start`` serves them.
    The broker is a ``BrokerServer`` in this process unless
    ``broker_url`` names a fresh one; with ``queued_first`` the stream
    records are enqueued before the loop starts, so no producer shares
    the process while it serves.  Checks that every record was answered
    once, that no record was dead-lettered, and that each served batch
    launched 12/12/1 kernels; returns the results and the timings."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_torch.observability import get_tracer
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.serving.client import (
        InputQueue, OutputQueue, ServingHttpClient)
    from analytics_zoo_torch.serving.redis_client import (
        BrokerServer, EmbeddedBroker, connect)
    from analytics_zoo_torch.serving.server import (
        DEAD_LETTER_STREAM, ClusterServing, ServingConfig)

    broker = None
    if broker_url is None:
        broker = BrokerServer(EmbeddedBroker())      # RESP over TCP
        broker_url = broker.url
    serving = ClusterServing(im, ServingConfig(
        redis_url=broker_url, batch_size=8, top_n=5, input_shape=(512,),
        batch_buckets=",".join(map(str, buckets)), consumer_group="g",
        http_port=0, metrics_host="127.0.0.1"))
    t0 = time.perf_counter()
    warmed = serving.engine.warm_start()
    warm_s = time.perf_counter() - t0
    if warmed != {"default": len(buckets)}:
        fail(f"warm_start warmed {warmed}, want {len(buckets)} buckets")

    rs = np.random.RandomState(1)
    records = rs.randint(0, 30522, size=(64, 512)).astype(np.int64)
    singles = rs.randint(0, 30522, size=(8, 512)).astype(np.int64)
    records, singles = records[:n_stream], singles[:n_singles]
    tracer = get_tracer()
    tracer.clear()
    kernels.reset_launch_counts()
    inq = InputQueue(broker_url)
    queued = len(records) if queued_first else 0
    for i in range(queued):
        inq.enqueue(f"s{i}", records[i], request_id=f"s{i}")
    # run() warms again: every bucket is already warm, so it launches
    # nothing
    loop = serving.start_background()
    http = ServingHttpClient(serving.http_transport.url)
    t_start = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(http.predict_http, "default", x,
                            request_id=f"h{i}")
                for i, x in enumerate(singles)]
        for i in range(queued, len(records)):
            inq.enqueue(f"s{i}", records[i], request_id=f"s{i}")
        http_docs = [f.result(timeout=300) for f in futs]
        deadline = time.perf_counter() + 300
        while serving.total_records < len(records) and \
                time.perf_counter() < deadline:
            time.sleep(0.005)
    wall = time.perf_counter() - t_start
    serving.stop()
    loop.join(60)
    if loop.is_alive():
        fail("ClusterServing.run did not stop")
    launches = kernels.launch_counts()

    outq = OutputQueue(broker_url)
    metas = [outq.query_meta(f"s{i}") for i in range(len(records))]
    dead = connect(broker_url).xlen(DEAD_LETTER_STREAM)
    if broker is not None:
        broker.stop()
    if serving.total_records != len(records) or dead:
        fail(f"stream records served {serving.total_records} of "
             f"{len(records)}, dead letters {dead}")
    results = []
    for i, meta in enumerate(metas):
        if meta is None or meta["request_id"] != f"s{i}" or \
                not isinstance(meta["value"], list):
            fail(f"stream record s{i}: result {meta}")
        results.append(meta["value"])
    for i, doc in enumerate(http_docs):
        if doc.get("request_id") != f"h{i}" or \
                not isinstance(doc.get("value"), list):
            fail(f"HTTP single h{i}: response {doc}")
        results.append(doc["value"])

    events = tracer.events()
    spans = [e for e in events if e["name"] == "serving_execute"]
    batches = len(spans)
    served = sum(e["args"]["records"] for e in spans)
    if served != len(records) + len(singles):
        fail(f"serving_execute spans hold {served} records, want "
             f"{len(records) + len(singles)} (each exactly once)")
    want = {name: 0 for name in kernels.SIGNATURES}
    want.update(flash_attention_fwd=12 * batches, bias_gelu=12 * batches,
                layernorm_act=batches)
    if launches != want:
        fail(f"cluster serving launch counts {launches} != {want} for "
             f"{batches} batches")
    lat = sorted(serving.latencies)
    return dict(
        inputs=np.concatenate([records, singles]), results=results,
        warm_s=warm_s, wall_s=wall, launches=launches, batches=batches,
        buckets=Counter(e["args"]["bucket"] for e in spans),
        execute_ms=[e["dur"] * 1e-3 for e in spans],
        batch_records=[e["args"]["records"] for e in spans],
        predict_ms=sum(e["dur"] for e in events
                       if e["name"] == "inference_predict") * 1e-3,
        p50_ms=lat[len(lat) // 2] * 1e3,
        p99_ms=lat[min(int(0.99 * len(lat)), len(lat) - 1)] * 1e3,
        n_latencies=len(lat))


def front_end(torch, im, card, fail, tag="cluster serving") -> None:
    """Phase 3b: ``serve_front_end`` at BERT-base width, its results
    against ``ops.fused=torch``, and its rates and times printed, each
    line starting with ``tag``."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.ops import kernels

    run = serve_front_end(torch, im, fail)
    print(f"{tag}: warm_start warmed 4 buckets (1/2/4/8 x 512 "
          f"tokens) in {run['warm_s']:.3f} s ({card})")
    get_config().set("ops.fused", "torch")
    plain = im.predict(run["inputs"], batch_size=8)
    get_config().set("ops.fused", "auto")
    if kernels.launch_counts() != run["launches"]:
        fail("ops.fused=torch launched a kernel")
    e_ = np.exp(plain - plain.max(-1, keepdims=True))
    probs = e_ / e_.sum(-1, keepdims=True)
    top2 = np.sort(plain, -1)[:, -2:]
    decided = compared = 0
    worst = 0.0
    for i, res in enumerate(run["results"]):
        classes = [c for c, _ in res]
        if len(res) != 5 or len(set(classes)) != 5:
            fail(f"record {i}: top-5 result {res}")
        worst = max(worst, max(abs(p - probs[i, c]) for c, p in res))
        if top2[i, 1] - top2[i, 0] > MODEL_ATOL:
            compared += 1
            decided += classes[0] == int(np.argmax(plain[i]))
    if decided != compared or not worst <= PROB_ATOL:
        fail(f"{tag} vs ops.fused=torch: top-1 agrees on "
             f"{decided} of {compared} decided records, probability max "
             f"abs diff {worst:.3e} (tolerance {PROB_ATOL})")
    n = len(run["results"])
    print(f"{tag} vs ops.fused=torch: top-1 identical on "
          f"{compared} of {n} records whose plain top-2 logit gap exceeds "
          f"{MODEL_ATOL}; probability max abs diff {worst:.3e} (tolerance "
          f"{PROB_ATOL})")
    wall = run["wall_s"]
    execute_s = sum(run["execute_ms"]) * 1e-3
    print(f"{tag}: {n} records (64 stream over TCP, 8 HTTP) in "
          f"{wall:.4f} s, {n / wall:.2f} records/s ({card})")
    print(f"{tag}: arrival->result latency p50 "
          f"{run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms over "
          f"{run['n_latencies']} stream records ({card})")
    print(f"{tag}: {run['batches']} batches served, by bucket "
          f"{dict(sorted(run['buckets'].items()))}, records "
          f"{run['batch_records']}, serving_execute ms "
          f"{[round(t, 3) for t in run['execute_ms']]}; launches "
          f"{run['launches']} ({card})")
    print(f"{tag}: front end host time "
          f"{(wall - execute_s) * 1e3 / n:.4f} ms a record (wall "
          f"{wall * 1e3:.3f} ms less serving_execute {execute_s * 1e3:.3f} "
          f"ms, over {n} records) ({card})")


# NeuralCF's loss after the same 43 steps from the same weights, twice a
# route.  The fused Adam kernel is bit-identical to its plain version
# (checked leaf by leaf below), so the routes take the same steps; the
# one order CUDA does not fix is that of the atomicAdds by which the
# embeddings' backward (index_add_) sums a batch's rows into a table row.
# Measured on the H100: the same loss to the last bit in all eight runs
# of two calls, a spread of 0.  Since CUDA does not promise that order,
# the tolerance leaves 1e-5 (3e-5 of the loss, ~0.35) for it.
NCF_LOSS_ATOL = 1e-5
# ranking metrics from evaluate against the same ranks taken on the host
# from predict's scores (the same forward, so ~1e-7 at most)
RANK_ATOL = 1e-6
NCF_BATCH = 16384
NCF_TIMED_STEPS = 40
WD_BATCH = 8192


def expect_launches(launches, want, what) -> None:
    """Fail unless the kernels launched exactly ``want`` (others 0)."""
    from analytics_zoo_torch.ops import kernels
    full = {name: 0 for name in kernels.SIGNATURES}
    full.update(want)
    if launches != full:
        fail(f"{what}: launch counts {launches} != {full}")


def host_ranks(scores, k, neg_num):
    """HitRatio@k and NDCG@k of the leave-one-out groups, in numpy, from
    the positive-class scores (one positive first in each group)."""
    s = scores[:, -1].reshape(-1, neg_num + 1)
    rank = (s[:, 1:] > s[:, :1]).sum(axis=1)
    hit = rank < k
    return (float(hit.mean()),
            float(np.where(hit, np.log(2.0) / np.log(rank + 2.0), 0.0).mean()))


def plain_route(fn):
    """``fn()`` under ``ops.fused=torch``: the plain versions."""
    from analytics_zoo_torch.common.config import get_config
    get_config().set("ops.fused", "torch")
    try:
        return fn()
    finally:
        get_config().set("ops.fused", "auto")


def opt_leaves_check(torch, leaves, what, sgd_momentum=0.9):
    """The multi-tensor Adam and SGD (momentum ``sgd_momentum``, 0.9
    unless given; 0 runs without a trace) kernels against their plain
    versions on copies of a model's leaves, each leaf with its own seeded
    gradient and moments: one update of every copy (one launch each),
    then every parameter, moment and trace compared leaf by leaf at
    OPT_ATOL.  Returns the largest error of Adam and of SGD."""
    from analytics_zoo_torch.ops import fused, kernels
    dev = leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(5)
    p = [t.detach().clone() for t in leaves]
    g, m, t = ([torch.randn(x.shape, generator=gen, device=dev) * 1e-2
                for x in leaves] for _ in range(3))
    v = [torch.rand(x.shape, generator=gen, device=dev) * 1e-4
         for x in leaves]
    count = torch.tensor(2, dtype=torch.int32, device=dev)
    adam_kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    sgd_kw = dict(momentum=sgd_momentum, nesterov=False)
    sgd_base, sgd_moments = ((p, g, t), (0, 2)) if sgd_momentum else \
        ((p, g), (0,))
    errs = {}
    kernels.reset_launch_counts()
    for name, base, run, moments in (
            ("fused_adam", (p, g, m, v), lambda *c: fused.adam_multi_update(
                *c, count, -1e-3, **adam_kw), (0, 2, 3)),
            ("fused_sgd", sgd_base, lambda p_, g_, t_=None:
                fused.sgd_multi_update(p_, g_, t_, -1e-3, **sgd_kw),
             sgd_moments)):
        kern = [[x.clone() for x in col] for col in base]
        plain = [[x.clone() for x in col] for col in base]
        run(*kern)
        plain_route(lambda: run(*plain))
        worst = 0.0
        for j in moments:
            for i, (a, b) in enumerate(zip(kern[j], plain[j])):
                worst = max(worst, close(
                    f"{what} {name} leaf {i} ({a.numel()} elements) operand "
                    f"{j}", a, b, OPT_ATOL))
        errs[name] = worst
        del kern, plain
    expect_launches(kernels.launch_counts(), {"fused_adam": 1,
                                              "fused_sgd": 1},
                    f"{what} optimizer check")
    print(f"check fused_adam and fused_sgd (momentum {sgd_momentum}"
          f"{'' if sgd_momentum else ', no trace'}; one multi-tensor launch "
          f"each) on {what}'s {len(leaves)} leaves "
          f"({sum(x.numel() for x in leaves)} elements, "
          f"{max(x.numel() for x in leaves)} down to "
          f"{min(x.numel() for x in leaves)}): param, moments and trace max "
          f"abs err Adam {errs['fused_adam']:.3e}, SGD {errs['fused_sgd']:.3e}"
          f" (tolerance {OPT_ATOL}: bit-identical)")
    return errs


def device_kernels(torch, fn):
    """The names of the device kernels ``fn()`` runs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def host_ms(torch, fn, n=TIMED) -> float:
    """Host time of one ``fn()`` call: the median over ``n`` calls, each
    made with nothing queued on the device (a step issues its update once,
    behind a few hundred launches at most).  Many launches queued at once
    would time the queue instead: a launch whose parameters exceed 4 KB
    waits for room in the driver's parameter buffers."""
    for _ in range(WARMUP):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def time_updates(torch, leaves, card, what, profile=False,
                 sgd_momentum=0.9):
    """The multi-tensor Adam and SGD (momentum ``sgd_momentum``, 0.9 unless
    given; 0 runs without a trace) updates over copies of
    a model's leaves, each timed (``time_ms``) as the kernel alone
    (``adam_multi_update`` / ``sgd_multi_update`` at a constant learning
    rate, the table kept), the step's whole fused update
    (``build_fused_update``) and one ``torch.optim.Adam``/``SGD(fused=True)
    .step`` over the same leaves, in turns; the plain version
    (``ops.fused=torch``), the bound and the whole update's host time
    (``host_ms``).  With ``profile``, a ``torch.profiler`` count of the
    device kernels of one whole Adam update and one whole SGD update (one
    profile: a second one in a process recorded no device events on the
    H100), which must be one each.  Returns {kernel: its numbers}."""
    from analytics_zoo_torch.ops import fused, kernels
    from analytics_zoo_torch.ops import multi_tensor as mt
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    dev = leaves[0].device
    n_el = sum(int(x.numel()) for x in leaves)
    gen = torch.Generator(device=dev).manual_seed(3)
    setups = {}
    for name, optim, lib_cls, lib_kw in (
            ("fused_adam", Adam(lr=1e-3), torch.optim.Adam, {}),
            ("fused_sgd", SGD(1e-3, momentum=sgd_momentum), torch.optim.SGD,
             dict(momentum=sgd_momentum))):
        ps = [x.detach().clone() for x in leaves]
        gs = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3
              for x in leaves]
        tree = {f"l{i:03d}": p for i, p in enumerate(ps)}
        gtree = {f"l{i:03d}": g for i, g in enumerate(gs)}
        state = [optim.init(tree)]
        update = fused.build_fused_update(optim)
        moments = [[torch.zeros_like(p) for p in ps]
                   for _ in range(2 if name == "fused_adam" else
                                  1 if sgd_momentum else 0)]
        cache = mt.TableCache()
        count = torch.zeros((), dtype=torch.int32, device=dev)
        if name == "fused_adam":
            def kernel(ps=ps, gs=gs, moments=moments, cache=cache,
                       count=count):
                fused.adam_multi_update(ps, gs, *moments, count, -1e-3,
                                        b1=0.9, b2=0.999, eps=1e-8,
                                        cache=cache)
        else:
            def kernel(ps=ps, gs=gs, moments=moments, cache=cache):
                fused.sgd_multi_update(ps, gs, moments[0] if moments else
                                       None, -1e-3, momentum=sgd_momentum,
                                       nesterov=False, cache=cache)

        def whole(update=update, state=state, tree=tree, gtree=gtree):
            _, state[0] = update(gtree, state[0], tree)
        lib_params = [p.clone().requires_grad_() for p in ps]
        for p, g in zip(lib_params, gs):
            p.grad = g.clone()
        lib = lib_cls(lib_params, lr=1e-3, fused=True, **lib_kw)
        setups[name] = dict(kernel=kernel, update=whole, library=lib.step,
                            lib_name=lib_cls.__name__, hold=(ps, gs, moments,
                                                             lib_params))
    out = {}
    for name, su in setups.items():
        runs = {tag: [] for tag in ("kernel", "update", "library")}
        kernels.reset_launch_counts()
        for tag in ("kernel", "update", "library", "library", "update",
                    "kernel"):
            runs[tag].append(time_ms(torch, su[tag]))
        if kernels.launch_counts()[name] != 4 * (WARMUP + TIMED):
            fail(f"{what} {name} timing launches {kernels.launch_counts()}")
        plain = time_ms(torch, lambda: plain_route(su["kernel"]))
        host = host_ms(torch, su["update"])
        # bytes an element: p read and written, g read, each moment or
        # trace read and written
        per_el = 28 if name == "fused_adam" else 20 if sgd_momentum else 12
        bnd, by = bound_ms(per_el * n_el, 0)
        med = {tag: statistics.median(r) for tag, r in runs.items()}
        out[name] = dict(ms=med["kernel"], update_ms=med["update"],
                         plain_ms=plain, library_ms=med["library"],
                         bound_ms=bnd, bound_by=by, host_ms=host,
                         leaves=len(leaves))
        print(f"{what} {name} over {len(leaves)} leaves ({n_el} elements, "
              f"{per_el * n_el} bytes), in turns: kernel (1 launch) "
              f"{runs['kernel']} ms, the step's whole fused update "
              f"{runs['update']} ms, {su['lib_name']}(fused=True).step "
              f"{runs['library']} ms; plain {plain:.5f} ms; bound "
              f"{bnd:.6f} ms ({by}); the whole update's host time "
              f"{host:.5f} ms a call ({card})")
    if profile:
        launched = device_kernels(torch, lambda: [
            su["update"]() for su in setups.values()])
        print(f"{what}: device kernels of one whole Adam update then one "
              f"whole SGD update (no clip, constant lr; torch.profiler): "
              f"{launched}")
        if len(launched) != 2 or "multi_adam" not in launched[0] or \
                "multi_sgd" not in launched[1]:
            fail(f"{what}: the whole updates ran device kernels {launched}, "
                 "want one multi_adam and one multi_sgd")
    del setups
    torch.cuda.empty_cache()
    return out


def ncf_phase(torch, card, users=None, items=None, n_ratings=1_000_000,
              batch=NCF_BATCH, timed_steps=NCF_TIMED_STEPS):
    """Phase 7: NeuralCF at ``bench_ncf``'s shape, trained, evaluated,
    ranked and timed; returns the launch counts of its ``fit``."""
    import itertools

    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.feature.datasets import movielens
    from analytics_zoo_torch.models.recommendation import NeuralCF
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.metrics import HitRatio, NDCG
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_map)

    users = users or movielens.ML1M_USERS
    items = items or movielens.ML1M_ITEMS
    loss_name = "sparse_categorical_crossentropy_with_logits"
    t0 = time.perf_counter()
    ratings = movielens.synthetic_ratings(users, items, n_ratings)
    train_x, train_y, eval_x, eval_y = movielens.build_ncf_samples(
        ratings, users, items, neg_per_pos=4, eval_neg=100)
    data_s = time.perf_counter() - t0
    model = NeuralCF(users, items, class_num=2, user_embed=64,
                     item_embed=64, mf_embed=64, hidden_layers=(128, 64, 32))
    model.model.init(torch.Generator().manual_seed(0))
    start = tree_map(torch.clone, model.get_variables()["params"])
    leaves = tree_leaves(start)
    n_params = sum(int(p.numel()) for p in leaves)
    model.compile(Adam(lr=1e-3), loss_name,
                  metrics=[HitRatio(10, 100), NDCG(10, 100)])
    steps = len(train_y) // batch
    print(f"ncf: {len(train_y)} training rows ({steps} steps of {batch}), "
          f"{len(eval_y)} eval rows, made in {data_s:.2f} s; {n_params} "
          f"params in {len(leaves)} float32 leaves")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = model.fit(train_x, train_y, batch_size=batch, nb_epoch=1,
                        rng=0)
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": steps}, "ncf fit")
    loss = history[0]["loss"]
    if len(history) != 1 or not np.isfinite(loss):
        fail(f"ncf fit history {history}")
    print(f"ncf fit: 1 epoch, {steps} steps in {fit_s:.3f} s (first epoch, "
          f"warm-up included), {history[0]['throughput']:.1f} samples/s, "
          f"epoch loss {loss:.6f}; launches {launches} ({card})")

    # train_step_at under prefetch, in turns, from the same start weights
    # over the same batches
    loss_fn = objectives.get(loss_name)
    train_set = FeatureSet.from_ndarrays(train_x, train_y)
    warm = 3

    def timed(mode):
        get_config().set("ops.fused", mode)
        tr = DistributedTrainer(model.model, loss_fn,
                                optim_method=Adam(lr=1e-3))
        params = tr.place_params(start)
        opt_state, state = tr.init_opt_state(params), {}
        kernels.reset_launch_counts()
        batches = itertools.islice(
            train_set.epoch_batches(1, batch, train=True),
            warm + timed_steps)
        torch.cuda.synchronize()
        for i, b in enumerate(tr.prefetch(batches)):
            if i == warm:
                torch.cuda.synchronize()
                s0 = time.perf_counter()
            params, opt_state, state, step_loss = tr.train_step_at(
                params, opt_state, state, b, 0, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - s0) * 1e3 / timed_steps
        counts = kernels.launch_counts()
        n = warm + timed_steps
        expect_launches(counts, {"fused_adam": n} if mode == "auto" else {},
                        f"ncf steps {mode}")
        return ms, float(step_loss)

    runs = {"torch": [], "auto": []}
    for mode in ("torch", "auto", "auto", "torch"):
        runs[mode].append(timed(mode))
    get_config().set("ops.fused", "auto")
    for mode in ("auto", "torch"):
        ms = [r[0] for r in runs[mode]]
        print(f"ncf step ops.fused={mode} (train_step_at under prefetch, "
              f"{timed_steps} steps a turn): {ms} ms, median "
              f"{statistics.median(ms):.4f} ms, "
              f"{batch * 1e3 / statistics.median(ms):.1f} samples/s ({card})")
    losses = [r[1] for mode in ("auto", "torch") for r in runs[mode]]
    spread = max(losses) - min(losses)
    same = max(abs(runs["auto"][0][1] - runs["auto"][1][1]),
               abs(runs["torch"][0][1] - runs["torch"][1][1]))
    print(f"ncf loss after {warm + timed_steps} steps from the same weights: "
          f"auto {[r[1] for r in runs['auto']]}, torch "
          f"{[r[1] for r in runs['torch']]}; spread {spread:.3e} (same "
          f"route twice {same:.3e}; tolerance {NCF_LOSS_ATOL})")
    if not spread <= NCF_LOSS_ATOL:
        fail(f"ncf losses under the two routes differ by {spread}")

    # evaluate on the 6040 x 101 leave-one-out rows, whole groups a batch
    t0 = time.perf_counter()
    scores = model.evaluate(eval_x, eval_y, batch_size=101 * 40)
    eval_s = time.perf_counter() - t0
    if set(scores) != {"loss", "hit_ratio@10", "ndcg@10"} or \
            not all(np.isfinite(v) and v >= 0 for v in scores.values()) or \
            not 0.0 < scores["hit_ratio@10"] <= 1.0:
        fail(f"ncf evaluate scores {scores}")
    t0 = time.perf_counter()
    out = model.predict(eval_x, batch_size=101 * 40)
    predict_s = time.perf_counter() - t0
    if out.shape != (len(eval_y), 2) or not np.isfinite(out).all():
        fail(f"ncf predict shape {out.shape}")
    hr, ndcg = host_ranks(out, 10, 100)
    err = max(abs(hr - scores["hit_ratio@10"]),
              abs(ndcg - scores["ndcg@10"]))
    if not err <= RANK_ATOL:
        fail(f"ncf HitRatio/NDCG {scores} against host ranks {hr}, {ndcg}")
    print(f"ncf evaluate ({len(eval_y)} rows, batch {101 * 40}) in "
          f"{eval_s:.3f} s: HitRatio@10 {scores['hit_ratio@10']:.6f}, "
          f"NDCG@10 {scores['ndcg@10']:.6f}, loss {scores['loss']:.6f}; "
          f"host ranks from predict agree within {err:.1e} (tolerance "
          f"{RANK_ATOL}); predict {predict_s:.3f} s ({card})")

    # the card's forward against the same forward on the CPU
    cpu_params = tree_map(lambda t: t.cpu(), model.get_variables()["params"])
    small = [a[:1010] for a in eval_x]
    with torch.no_grad():
        ref, _ = model.model.apply(cpu_params,
                                   [torch.as_tensor(a) for a in small])
    diff = float(np.abs(out[:1010] - ref.numpy()).max())
    print(f"ncf predict on the card vs the CPU, 1010 rows: logits max abs "
          f"diff {diff:.3e} (tolerance {MODEL_ATOL})")
    if not diff <= MODEL_ATOL:
        fail(f"ncf card and CPU logits differ by {diff}")

    for method, ids, cands in (("recommend_for_user", [1, 2, 3],
                                range(1, items + 1)),
                               ("recommend_for_item", [1, 2, 3],
                                range(1, users + 1))):
        t0 = time.perf_counter()
        recs = getattr(model, method)(ids, cands, 10)
        rec_s = time.perf_counter() - t0
        ranked = {}
        for key in ids:
            r = recs.get(key, [])
            sc = [p.probability for p in r]
            ranked[key] = [p.item_id if method == "recommend_for_user"
                           else p.user_id for p in r]
            if len(r) != 10 or sc != sorted(sc, reverse=True) or \
                    len(set(ranked[key])) != 10 or \
                    not all(1 <= o <= len(cands) for o in ranked[key]) or \
                    not all(np.isfinite(sc)):
                fail(f"ncf {method}({key}): {r}")
        print(f"ncf {method}({ids}, {len(cands)} candidates, 10): {ranked} "
              f"in {rec_s * 1e3:.1f} ms")

    # the 12-leaf updates alone: the kernels against the plain versions leaf
    # by leaf, then timed beside the step's whole fused update, the plain
    # versions and torch.optim's fused Adam and SGD
    errs = opt_leaves_check(torch, leaves, "NeuralCF")
    times = time_updates(torch, leaves, card, "ncf")
    # 7b: the trained model calibrated to int8
    ncf_int8(torch, card, model, eval_x, eval_y, users, items)
    return launches, errs, times


def wide_deep_phase(torch, card, rows=1 << 19, batch=WD_BATCH):
    """Phase 8: Wide & Deep at the census configuration, trained with
    validation and evaluated; the Adam and SGD kernels held and timed on
    its 11 leaves; returns the launch counts of its ``fit``, the kernels'
    errors and their times."""
    from analytics_zoo_torch.models.recommendation import (
        ColumnFeatureInfo, WideAndDeep)
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves

    info = ColumnFeatureInfo(
        wide_base_cols=["gender", "age_bucket", "education"],
        wide_base_dims=[3, 10, 16],
        wide_cross_cols=["gender_age", "edu_age"],
        wide_cross_dims=[30, 160],
        embed_cols=["occupation", "relationship"],
        embed_in_dims=[48, 8], embed_out_dims=[16, 8],
        continuous_cols=["hours_per_week", "capital_gain"])
    rs = np.random.RandomState(0)
    gender = rs.randint(0, 3, rows)
    age = rs.randint(0, 10, rows)
    edu = rs.randint(0, 16, rows)
    occ = rs.randint(0, 48, rows)
    rel = rs.randint(0, 8, rows)
    hours = rs.rand(rows).astype(np.float32)
    gain = rs.rand(rows).astype(np.float32)
    cols = {"gender": gender, "age_bucket": age, "education": edu,
            "gender_age": gender * 10 + age, "edu_age": edu * 10 + age,
            "occupation": occ, "relationship": rel,
            "hours_per_week": hours, "capital_gain": gain}
    logit = (((gender == 1) & (age >= 5)) * 1.2
             + np.sin(occ / 48 * np.pi) + hours + gain - 1.8)
    label = (logit + 0.3 * rs.randn(rows) > 0).astype(np.int64)

    model = WideAndDeep(2, info, model_type="wide_n_deep",
                        hidden_layers=(64, 32, 16))
    model.model.init(torch.Generator().manual_seed(0))
    n_leaves = len(tree_leaves(model.get_variables()["params"]))
    feats = model.features_from_columns(cols)
    model.compile(Adam(lr=1e-3),
                  "sparse_categorical_crossentropy_with_logits",
                  metrics=["accuracy", "auc"])
    steps = int(rows * (1 - 0.1)) // batch
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = model.fit(feats, label, batch_size=batch, nb_epoch=2,
                        validation_split=0.1, rng=0)
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": steps * 2},
                    "wide & deep fit")
    if len(history) != 2 or any(
            set(h.get("val", {})) != {"sparse_categorical_accuracy", "auc"}
            or not np.isfinite(h["loss"]) for h in history):
        fail(f"wide & deep fit history {history}")
    for h in history:
        print(f"wide & deep epoch {h['epoch']}: {steps} steps of {batch}, "
              f"{h['wall_s'] * 1e3 / steps:.4f} ms a step, "
              f"{h['throughput']:.1f} samples/s, loss {h['loss']:.6f}, val "
              f"{h['val']} ({card})")
    scores = model.evaluate(feats, label, batch_size=batch)
    if set(scores) != {"loss", "sparse_categorical_accuracy", "auc"} or \
            not all(np.isfinite(v) for v in scores.values()) or \
            not 0.0 <= scores["sparse_categorical_accuracy"] <= 1.0:
        fail(f"wide & deep evaluate scores {scores}")
    print(f"wide & deep: fit 2 epochs in {fit_s:.3f} s ({n_leaves} float32 "
          f"leaves), launches {launches}; evaluate {scores} ({card})")
    leaves = tree_leaves(model.get_variables()["params"])
    errs = opt_leaves_check(torch, leaves, "Wide & Deep")
    return launches, errs, time_updates(torch, leaves, card, "wide & deep")


# The int8 products against their plain routes on the card: both are exact
# integer arithmetic (int32 sums of int8 products; the plain route's
# float64 sums stay below 2^53) under the same float32 epilogue, so they
# agree bit for bit.
INT8_ATOL = 0.0
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
# the JAX package's int8 bars against float32 (tests/test_quant_int8.py)
INT8_PROB_ATOL = 2e-2
INT8_AGREE_MIN = 0.97
NCF_PREDICT_ROWS = 65536
NCF_PREDICT_BATCH = 8192

# (name, kind, input shape, kernel shape, conv arguments): the shapes the
# int8 paths give the products
INT8_CASES = (
    ("BERT-base head Dense", "mm", (8, 768), (768, 256), None),
    ("NCF Dense 128->128", "mm", (8192, 128), (128, 128), None),
    ("NCF Dense 128->64", "mm", (8192, 128), (128, 64), None),
    ("NCF Dense 64->32", "mm", (8192, 64), (64, 32), None),
    ("one-row batch Dense", "mm", (1, 768), (768, 256), None),
    ("TextClassifier cnn Convolution1D", "conv", (8, 500, 200),
     (5, 200, 256), dict(strides=(1,), padding="VALID",
                         rhs_dilation=(1,))),
    ("strided SAME Convolution2D", "conv", (8, 56, 56, 64), (3, 3, 64, 128),
     dict(strides=(2, 2), padding="SAME", rhs_dilation=(1, 1))),
)


def int8_products(torch, card, dev):
    """Phase 2b: ``quantized_matmul`` and ``quantized_conv`` on the card
    against their plain routes on the card (tolerance 0), each timed beside
    the plain route and the bf16 product (``ops.dtypes.matmul``,
    ``conv_nd``) at the same shape; returns the readings."""
    from analytics_zoo_torch.ops import quant
    from analytics_zoo_torch.ops.dtypes import matmul
    from analytics_zoo_torch.pipeline.api.keras.layers.conv import conv_nd

    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for name, kind, xs, ks, conv in INT8_CASES:
        x = torch.randn(xs, generator=gen, device=dev)
        w = torch.randn(ks, generator=gen, device=dev) * 0.05
        axes = tuple(range(w.ndim - 1))
        w_scale = (w.abs().amax(dim=axes, keepdim=True) / 127.0
                   ).clamp_min(1e-12)
        kq = quant.int8_kernel_layout(
            torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8))
        act = (x.abs().max() / 127.0).reshape(())
        if kind == "mm":
            def run(x=x, kq=kq, w_scale=w_scale, act=act):
                return quant.quantized_matmul(x, kq, w_scale, act)

            def bf16(x=x, w=w):
                return matmul(x, w)
        else:
            def run(x=x, kq=kq, w_scale=w_scale, act=act, conv=conv):
                return quant.quantized_conv(x, kq, w_scale, act, **conv)

            def bf16(x=x, w=w, conv=conv):
                return conv_nd(x, w, conv["strides"], conv["padding"],
                               conv["rhs_dilation"])
        got, want = run(), plain_route(run)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"int8 {name} {xs} x {ks}: the card route and the plain "
                 f"route differ (max abs "
                 f"{float((got - want).abs().max()):.3e}, tolerance "
                 f"{INT8_ATOL})")
        # each output element takes one multiply-add per kernel element of
        # its output channel
        ops = 2 * got.numel() * int(np.prod(ks[:-1]))
        moved = x.numel() * 4 + kq.numel() + w_scale.numel() * 4 + \
            got.numel() * 4
        ms = time_ms(torch, run)
        plain_ms = plain_route(lambda: time_ms(torch, run))
        bf16_ms = time_ms(torch, bf16)
        bnd, by = bound_ms(moved, ops, INT8_OPS_PER_S)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         bf16_ms=bf16_ms, bound_ms=bnd, bound_by=by))
        print(f"int8 {name} {xs} x {ks} -> {tuple(got.shape)}: card route "
              f"== plain route bit for bit (tolerance {INT8_ATOL}); "
              f"int8_ms {ms:.5f} plain_ms {plain_ms:.5f} bf16_ms "
              f"{bf16_ms:.5f} bound_ms {bnd:.6f} ({by}, int8 peak) "
              f"({card})")
    return rows


def _tree_bytes(tree) -> int:
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t is not None)


def int8_serving(torch, card, model, im, requests, outs):
    """Phase 3c: the BERT-base TextClassifier served weight-only int8
    through ``InferenceModel.load_zoo(quantize=True)``: 4 requests with
    the launches checked, the logits against the same int8 model under
    ``ops.fused=torch`` and against the float32 model, the parameters'
    device memory and the dequantization's time, then phase 3b's Cluster
    Serving traffic on it; returns the launch counts of the requests."""
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.pipeline.inference.inference_model import (
        dequantize_params)

    t0 = time.perf_counter()
    imq = InferenceModel().load_zoo(model, quantize=True)
    load_s = time.perf_counter() - t0
    n_int8 = sum(s is not None for s in imq._scales)
    f32_bytes = _tree_bytes(im._variables["params"])
    int8_bytes = _tree_bytes(imq._variables["params"]) + \
        _tree_bytes(imq._scales)
    print(f"int8 weight-only: {n_int8} leaves int8 on the device, "
          f"quantized in {load_s:.2f} s; parameters {int8_bytes} bytes "
          f"(scales included) against {f32_bytes} float32, "
          f"{f32_bytes / int8_bytes:.3f}x less ({card})")
    imq.predict(requests[0], batch_size=8)          # warm-up, not counted
    kernels.reset_launch_counts()
    qouts = [imq.predict(req, batch_size=8) for req in requests]
    launches = kernels.launch_counts()
    expect_launches(launches, {"flash_attention_fwd": 48, "bias_gelu": 48,
                               "layernorm_act": 4},
                    "int8 weight-only serving, 4 requests")
    for out in qouts:
        if out.shape != (8, 20) or not np.isfinite(out).all():
            fail(f"int8 weight-only output shape {out.shape}")
    plain = plain_route(lambda: imq.predict(requests[0], batch_size=8))
    if kernels.launch_counts() != launches:
        fail("ops.fused=torch launched a kernel")
    diff = float(np.abs(plain - qouts[0]).max())
    print(f"int8 weight-only: launches over 4 requests {launches}; "
          f"ops.fused=torch vs kernels, logits max abs diff {diff:.3e} "
          f"(tolerance {MODEL_ATOL})")
    if not diff <= MODEL_ATOL:
        fail(f"int8 weight-only kernel and plain logits differ by {diff}")
    q, f = np.concatenate(qouts), np.concatenate(outs)
    agree = float(np.mean(np.argmax(q, -1) == np.argmax(f, -1)))
    print(f"int8 weight-only vs float32 weights, {len(q)} sequences: top-1 "
          f"agreement {agree:.4f}, logits max abs diff "
          f"{float(np.abs(q - f).max()):.4e} (logits max abs "
          f"{float(np.abs(f).max()):.4e}); not gated")
    deq_ms = time_ms(torch, lambda: dequantize_params(
        imq._variables["params"], imq._scales))
    deq_host = host_ms(torch, lambda: dequantize_params(
        imq._variables["params"], imq._scales))
    # each int8 element read once and its float32 written once
    n_q = sum(t.numel() for t, s in zip(tree_leaves(imq._variables["params"]),
                                        imq._scales) if s is not None)
    deq_bnd, _ = bound_ms(5 * n_q + _tree_bytes(imq._scales), 0)
    print(f"int8 weight-only: the dequantization of every int8 leaf "
          f"{deq_ms:.5f} ms of device time a request (bound {deq_bnd:.6f} "
          f"ms, bytes), {deq_host:.5f} ms of host time ({card})")
    lat = {"f32": [], "int8": []}
    for mode in ("f32", "int8", "int8", "f32"):
        m = im if mode == "f32" else imq
        for req in requests:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            m.predict(req, batch_size=8)
            lat[mode].append((time.perf_counter() - s0) * 1e3)
    for mode, v in lat.items():
        med = statistics.median(v)
        print(f"int8 weight-only serving, {mode} weights: per-request "
              f"latency median {med:.3f} ms over {[round(t, 3) for t in v]} "
              f"(turns f32/int8/int8/f32), {8 * 1e3 / med:.1f} "
              f"sequences/s ({card})")
    front_end(torch, imq, card, fail, tag="int8 weight-only cluster serving")
    return launches


def ncf_int8(torch, card, model, eval_x, eval_y, users, items):
    """Phase 7b: the NeuralCF phase 7 trained, calibrated as the JAX
    ``kernels`` bench does (4 x 1024 rows, batch 1024), then
    ``NCF_PREDICT_ROWS`` rows predicted at batch ``NCF_PREDICT_BATCH``
    under float32 and int8 weights in turns, held to the JAX package's
    int8 bars, and HitRatio@10/NDCG@10 of each."""
    rs = np.random.RandomState(0)
    feats = model.pair_features(rs.randint(1, users + 1, NCF_PREDICT_ROWS),
                                rs.randint(1, items + 1, NCF_PREDICT_ROWS))
    f32_vars = model.get_variables()
    f32_out = model.predict(feats, batch_size=NCF_PREDICT_BATCH)
    t0 = time.perf_counter()
    model.quantize([a[:4 * 1024] for a in feats], batch_size=1024,
                   max_batches=4)
    calib_s = time.perf_counter() - t0
    q_vars = model.get_variables()
    q_layers = sorted(k for k, p in q_vars["params"].items()
                      if "kernel_scale" in p)
    if len(q_layers) != 3:
        fail(f"ncf int8: quantized layers {q_layers}, want the 3 MLP Denses")
    int8_out = model.predict(feats, batch_size=NCF_PREDICT_BATCH)
    e32 = np.exp(f32_out - f32_out.max(-1, keepdims=True))
    e8 = np.exp(int8_out - int8_out.max(-1, keepdims=True))
    prob_diff = float(np.abs(e32 / e32.sum(-1, keepdims=True)
                             - e8 / e8.sum(-1, keepdims=True)).max())
    agree = float(np.mean(np.argmax(f32_out, -1) == np.argmax(int8_out, -1)))
    print(f"ncf int8: calibrated in {calib_s:.3f} s, quantized {q_layers}; "
          f"{NCF_PREDICT_ROWS} rows: softmax max abs diff {prob_diff:.4e} "
          f"(bar {INT8_PROB_ATOL}), class agreement {agree:.5f} (bar "
          f"{INT8_AGREE_MIN}), logits max abs diff "
          f"{float(np.abs(f32_out - int8_out).max()):.4e}")
    if not (prob_diff < INT8_PROB_ATOL and agree >= INT8_AGREE_MIN):
        fail("ncf int8 misses the JAX package's bars")
    rates = {"f32": [], "int8": []}
    for mode in ("f32", "int8", "int8", "f32"):
        model.set_variables(f32_vars if mode == "f32" else q_vars)
        model.predict(feats, batch_size=NCF_PREDICT_BATCH)      # warm
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        model.predict(feats, batch_size=NCF_PREDICT_BATCH)
        rates[mode].append(NCF_PREDICT_ROWS / (time.perf_counter() - s0))
    for mode, r in rates.items():
        print(f"ncf predict {mode}: {[round(v, 1) for v in r]} rows/s "
              f"({NCF_PREDICT_ROWS} rows at batch {NCF_PREDICT_BATCH}, "
              f"turns f32/int8/int8/f32) ({card})")
    scores = {}
    for mode, v in (("f32", f32_vars), ("int8", q_vars)):
        model.set_variables(v)
        scores[mode] = model.evaluate(eval_x, eval_y, batch_size=101 * 40)
        if not 0.0 < scores[mode]["hit_ratio@10"] <= 1.0:
            fail(f"ncf {mode} evaluate {scores[mode]}")
    print(f"ncf evaluate ({len(eval_y)} rows): int8 HitRatio@10 "
          f"{scores['int8']['hit_ratio@10']:.6f} NDCG@10 "
          f"{scores['int8']['ndcg@10']:.6f}; float32 HitRatio@10 "
          f"{scores['f32']['hit_ratio@10']:.6f} NDCG@10 "
          f"{scores['f32']['ndcg@10']:.6f} ({card})")
    model.set_variables(f32_vars)


def cnn_int8(torch, card):
    """Phase 9: ``TextClassifier(encoder="cnn")`` at its default widths
    (tokens 200, sequence 500, 256 filters of width 5, 5000 words; 20
    classes), seeded weights, loaded calibrated through ``InferenceModel``
    and predicted on 8 x 500 tokens, held to its plain route
    (``ops.fused=torch``: the int8 products' plain route)."""
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.pipeline.inference import InferenceModel

    model = TextClassifier(class_num=20)
    model.model.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(2)
    calib = rs.randint(0, 5001, size=(32, 500)).astype(np.int64)
    x = rs.randint(0, 5001, size=(8, 500)).astype(np.int64)
    im32 = InferenceModel().load_zoo(model)
    t0 = time.perf_counter()
    imq = InferenceModel().load_zoo(model, quantize="calibrated",
                                    calib_set=calib, calib_batch_size=8,
                                    calib_batches=4)
    calib_s = time.perf_counter() - t0
    q_layers = sorted(k for k, p in imq._variables["params"].items()
                      if "kernel_scale" in p)
    if "convolution1d_1" not in q_layers or len(q_layers) != 3:
        fail(f"cnn int8: quantized layers {q_layers}")
    f32 = im32.predict(x, batch_size=8)
    got = imq.predict(x, batch_size=8)
    plain = plain_route(lambda: imq.predict(x, batch_size=8))
    if got.shape != (8, 20) or not np.isfinite(got).all():
        fail(f"cnn int8 output shape {got.shape}")
    diff = float(np.abs(got - plain).max())
    print(f"cnn int8: calibrated in {calib_s:.3f} s, quantized {q_layers}; "
          f"8 x 500 tokens: card route vs plain route logits max abs diff "
          f"{diff:.3e} (tolerance {MODEL_ATOL}); vs float32 top-1 agreement "
          f"{float(np.mean(np.argmax(got, -1) == np.argmax(f32, -1))):.3f}, "
          f"logits max abs diff {float(np.abs(got - f32).max()):.4e}")
    if not diff <= MODEL_ATOL:
        fail(f"cnn int8 card and plain routes differ by {diff}")
    lat = {"f32": [], "int8": []}
    for mode in ("f32", "int8", "int8", "f32"):
        im = im32 if mode == "f32" else imq
        im.predict(x, batch_size=8)
        torch.cuda.synchronize()
        for _ in range(5):
            s0 = time.perf_counter()
            im.predict(x, batch_size=8)
            lat[mode].append((time.perf_counter() - s0) * 1e3)
    for mode, v in lat.items():
        print(f"cnn predict {mode} (8 x 500 tokens): median "
              f"{statistics.median(v):.3f} ms over {[round(t, 3) for t in v]}"
              f" ({card})")


# ------------------------------------------- phases 10-12: the recurrent slice
# Phase 10: the lstm/gru TextClassifier at the reference's defaults (JAX
# and Scala TextClassifier) with news20's 20 classes.
RNN_CFG = dict(class_num=20, token_length=200, sequence_length=500,
               encoder_output_dim=256, max_words_num=5000)
# Card logits against the same model and weights on the CPU.  Under
# float32 products cuBLAS and the CPU's BLAS sum each product in another
# order (~1e-7 relative) and the recurrence carries that through 500 steps:
# RNN_F32_ATOL.  Under bf16 products a value that such a difference moves
# across a bf16 rounding boundary moves 2^-8 relative and carries on:
# RNN_BF16_ATOL, the whole-model bound phase 3 holds.
RNN_F32_ATOL = 1e-4
RNN_BF16_ATOL = MODEL_ATOL
# Phase 11: bench_serving_generative's configuration (bench.py:846-857).
GEN_VOCAB, GEN_START, GEN_STOP = 512, 1, 2
GEN_REQUESTS, GEN_SLOTS, GEN_MAX_LEN, GEN_ENC_LEN = 64, 16, 32, 12
GEN_BUDGETS = ([4, 6, 8, 12, 16, 24, 32], [.25, .2, .2, .15, .1, .05, .05])
# a served token is held to infer's row only while the greedy choice is
# clear: up to the first step whose top-2 logit margin is below this
# (float32 products; batches of other sizes sum in other orders)
GEN_MARGIN = 1e-3
# Phase 12: SessionRecommender's class defaults over MovieLens-1M's items;
# top-5 items compared where their scores are further apart than this
SESSION_ITEMS = 3706
RANK_GAP = 1e-5


def sync_host_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cpu_forward(torch, net, x):
    """``net``'s forward on a CPU copy of its variables: the same model
    and weights, the CPU's kernels."""
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_map)
    v = to_device(net.get_variables(), torch.device("cpu"))
    with torch.inference_mode():
        out, _ = net.apply(v["params"], tree_map(torch.from_numpy, x),
                           state=v["state"])
    return out.numpy()


def recurrent_models(torch):
    from analytics_zoo_torch.models.textclassification import TextClassifier
    models = {}
    for enc in ("lstm", "gru", "cnn"):
        m = TextClassifier(encoder=enc, **RNN_CFG)
        m.model.init(torch.Generator().manual_seed(0))
        models[enc] = m
    x = np.random.RandomState(4).randint(0, 5001, size=(8, 500)).astype(
        np.int64)
    return models, x


def spread_logits(params, embedding, head):
    """The initializers' weights with the embedding table x40 and the
    output layer's kernel x300.  At the initializers' scale the top-2
    logits of Seq2seq and SessionRecommender lie ~1e-7 apart, so the
    order of a sum, not the model, would decide the greedy token or the
    ranking the card is held to; the recurrences keep their initialized
    weights, which do not amplify such differences over the steps."""
    params[embedding]["embeddings"].mul_(40.0)
    params[head]["kernel"].mul_(300.0)


def seq2seq_model(torch):
    from analytics_zoo_torch.models.seq2seq import Seq2seq
    m = Seq2seq(vocab_size=GEN_VOCAB, embed_dim=64, hidden_sizes=(192,))
    m.init(torch.Generator().manual_seed(0))
    spread_logits(m.get_variables()["params"], m.embedding.name,
                  m.generator.name)
    rs = np.random.RandomState(0)
    enc = rs.randint(3, GEN_VOCAB, (GEN_REQUESTS, GEN_ENC_LEN)).astype(
        np.int32)
    budgets = rs.choice(GEN_BUDGETS[0], size=GEN_REQUESTS,
                        p=GEN_BUDGETS[1]).astype(int)
    return m, enc, budgets


# what a device kernel computes, read from its name: the first of these
# words it holds (cuBLAS's Hopper GEMMs are named nvjet_*)
KERNEL_KINDS = ("Memcpy", "Memset", "nvjet", "gemm", "sigmoid", "tanh",
                "Mul", "add", "sub", "bfloat16_copy", "index_copy",
                "indexSelect", "index_fill", "ArgMax", "CatArray", "where",
                "fill", "copy", "compare")


def kernel_kind(name: str) -> str:
    return next((k for k in KERNEL_KINDS if k in name), name[:40])


def profile_ranges(torch, runs, kind):
    """One ``torch.profiler`` session (a second one in a process recorded
    no device events on the H100) over ``runs`` (name -> fn), each in a
    ``record_function`` range that ends with a synchronize.  Returns
    ({name: summary}, the device events placed in no range as [name,
    start us from the first range's start, us, its launching call's
    start or None]); a summary holds
    the device kernels launched, memory copies, device busy ms (the union
    of the events' intervals), the kernels' summed ms, the range's wall ms,
    the idle share, the events placed by time for want of a launching
    call, and (count, ms) by ``kind(kernel name)``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in runs.items():
            with record_function(name):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # each range shows twice: its CPU interval, and on the device timeline
    # the interval of the work launched in it.  A device event is placed
    # by the runtime call that launched it: in the range whose CPU
    # interval holds that call's start.  An event with no such call is
    # placed in the range whose CPU or device interval holds it.  Device
    # times alone misplace events at a range's edge: in one phase-10
    # profile on an H100 the first 127 device events of a request lay
    # outside every device interval, and in another a request's first
    # input copy lay before its range's CPU start.  The wall is the
    # device interval, where there is one
    pieces = {}
    for e in events:
        if e.name in runs:
            key = (e.name, e.device_type == cuda)
            lo, hi = pieces.get(key, (e.time_range.start, e.time_range.end))
            pieces[key] = (min(lo, e.time_range.start),
                           max(hi, e.time_range.end))
    spans, walls = {}, {}
    for name in runs:
        held = [pieces[k] for k in ((name, False), (name, True))
                if k in pieces]
        spans[name] = (min(lo for lo, _ in held), max(hi for _, hi in held))
        lo, hi = pieces.get((name, True), held[0])
        walls[name] = (hi - lo) * 1e-3
    # a device event's id is the correlation id of the CUDA runtime or
    # driver call that launched it (cudaLaunchKernel, cudaMemcpyAsync,
    # cuLaunchKernel, ...); op and range ids come from another counter
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type != cuda and e.name.startswith("cu")}
    cpu_spans = {name: pieces[(name, False)] for name in runs
                 if (name, False) in pieces}
    placed = {name: [] for name in runs}
    by_time = Counter()
    first = min(lo for lo, _ in spans.values())
    unplaced = []
    for e in events:
        # the ranges themselves show on the device timeline too
        if e.device_type != cuda or e.name in runs:
            continue
        at = launched_at.get(e.id)
        if at is not None:
            where = [n for n, (lo, hi) in cpu_spans.items()
                     if lo <= at <= hi]
        else:
            where = [n for n, (lo, hi) in spans.items()
                     if lo <= e.time_range.start <= hi]
        if len(where) != 1:
            unplaced.append([e.name, e.time_range.start - first,
                             e.time_range.elapsed_us(),
                             None if at is None else at - first])
            continue
        placed[where[0]].append(e)
        by_time[where[0]] += at is None
    out = {}
    for name, evs in placed.items():
        copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in evs)
        count, total = Counter(), Counter()
        for e in evs:
            count[kind(e.name)] += 1
            total[kind(e.name)] += e.time_range.elapsed_us() * 1e-3
        busy, end = 0.0, -np.inf
        for s0, e0 in sorted((e.time_range.start, e.time_range.end)
                             for e in evs):
            if e0 > end:
                busy += (e0 - max(s0, end)) * 1e-3
                end = e0
        wall = walls[name]
        out[name] = dict(
            launches=len(evs) - copies, copies=copies, busy_ms=busy,
            sum_ms=sum(total.values()), wall_ms=wall,
            idle_share=1.0 - busy / wall, placed_by_time=by_time[name],
            by_kind=[(k, count[k], round(t, 4))
                     for k, t in total.most_common()])
    return out, unplaced


def profile_recurrent() -> None:
    """``--profile-recurrent``: in a process of its own (a second
    ``torch.profiler`` session in one process recorded no device events on
    the H100), one session over one lstm request, one gru request (8 x 500
    tokens through ``InferenceModel.predict``) and one decode iteration of
    a full 16-slot pool (``DecodeSlotPool.step_once``), each in a
    ``record_function`` range that ends with a synchronize.  Prints one
    JSON line: per range the device kernels launched, memory copies,
    device busy ms, the range's wall ms and the idle share."""
    import torch

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.serving.engine import Request
    from analytics_zoo_torch.serving.engine.decode import GenerativeEndpoint
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    init_zoo_context(device="cuda:0")
    models, x = recurrent_models(torch)
    ims = {enc: InferenceModel().load_zoo(models[enc])
           for enc in ("lstm", "gru")}
    m, enc, _ = seq2seq_model(torch)
    ep = GenerativeEndpoint("chat", m, enc_len=GEN_ENC_LEN,
                            start_sign=GEN_START, stop_sign=None,
                            max_seq_len=10_000, slots=GEN_SLOTS)
    ep.warm()
    reqs = [Request(endpoint="chat", uri=f"p{i}", data=enc[i])
            for i in range(GEN_SLOTS)]
    if ep.pool.admit(reqs) != GEN_SLOTS:
        fail("profile: the pool admitted fewer than 16 sequences")
    runs = {"lstm_request": lambda: ims["lstm"].predict(x, batch_size=8),
            "gru_request": lambda: ims["gru"].predict(x, batch_size=8),
            "decode_iteration_16": ep.pool.step_once}
    for fn in runs.values():
        fn()
    out, unplaced = profile_ranges(torch, runs, kernel_kind)
    for o in out.values():
        o["top"] = o.pop("by_kind")[:6]
    print(json.dumps({"profile": out, "unplaced": unplaced}))


def recurrent_phase(torch, card):
    """Phase 10: the lstm and gru TextClassifier at the reference width,
    served through ``InferenceModel``: logits on the card against the
    same model on the CPU (float32 and bf16 products), request latency in
    turns with the cnn encoder, launches, busy time and idle share from a
    profile in a child process, and weight-only int8 on the lstm."""
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    models, x = recurrent_models(torch)
    ims = {enc: InferenceModel().load_zoo(m) for enc, m in models.items()}
    default = dtypes.get_policy()
    kernels.reset_launch_counts()
    for enc in ("lstm", "gru"):
        net = models[enc].model
        for products, atol in (("float32", RNN_F32_ATOL),
                               ("bfloat16", RNN_BF16_ATOL)):
            if products == "float32":
                dtypes.set_policy("float32", "float32")
            else:
                dtypes.restore_policy(default)
            got = ims[enc].predict(x, batch_size=8)
            want = cpu_forward(torch, net, x)
            if got.shape != (8, 20) or not np.isfinite(got).all():
                fail(f"{enc} TextClassifier output shape {got.shape}")
            diff = float(np.abs(got - want).max())
            print(f"{enc} TextClassifier (8 x 500 tokens, {products} "
                  f"products): card vs CPU logits max abs diff {diff:.3e} "
                  f"(tolerance {atol}), logits max abs "
                  f"{float(np.abs(want).max()):.3e}, top-1 agreement "
                  f"{float(np.mean(got.argmax(-1) == want.argmax(-1))):.3f}")
            if not diff <= atol:
                fail(f"{enc} TextClassifier card and CPU logits differ by "
                     f"{diff} > {atol} under {products} products")
    dtypes.restore_policy(default)
    if sum(kernels.launch_counts().values()):
        fail(f"the recurrent TextClassifier launched a kernel "
             f"{kernels.launch_counts()}: its path has none")
    for enc in ("lstm", "gru"):
        layer = next(l for l in models[enc].model.layers
                     if l.name.startswith(enc))
        params = models[enc].get_variables()["params"][layer.name]
        u = params["recurrent_kernel"].to(default.compute_dtype)
        gen = torch.Generator(device=u.device).manual_seed(0)
        xt = torch.randn((8, u.shape[1]), generator=gen, device=u.device)
        carry = layer.initial_carry(8, u.device)

        def one_step(layer=layer, params=params, u=u, carry=carry, xt=xt):
            with torch.inference_mode():
                layer.step(params, u, carry, xt)
        step = time_ms(torch, one_step)
        print(f"{enc} timestep (8 x 256, bf16 products) on the device, "
              f"queued behind a spin: {step:.5f} ms, x 500 steps = "
              f"{500 * step:.3f} ms of device time a request ({card})")
    lat = {enc: [] for enc in ims}
    for enc in ("lstm", "gru", "cnn", "cnn", "gru", "lstm"):
        ims[enc].predict(x, batch_size=8)
        for _ in range(4):
            s0 = time.perf_counter()
            ims[enc].predict(x, batch_size=8)       # returns host numpy
            lat[enc].append((time.perf_counter() - s0) * 1e3)
    for enc, v in lat.items():
        print(f"{enc} TextClassifier predict (8 x 500 tokens, bf16 "
              f"products), in turns: median {statistics.median(v):.3f} ms "
              f"over {[round(t, 3) for t in v]} ({card})")
    q = InferenceModel().load_zoo(models["lstm"], quantize=True)
    got, f32 = q.predict(x, batch_size=8), ims["lstm"].predict(x, 8)
    if got.shape != (8, 20) or not np.isfinite(got).all():
        fail(f"lstm weight-only int8 output shape {got.shape}")
    print(f"lstm weight-only int8 vs float32 weights (8 x 500 tokens): "
          f"top-1 agreement "
          f"{float(np.mean(got.argmax(-1) == f32.argmax(-1))):.3f}, logits "
          f"max abs diff {float(np.abs(got - f32).max()):.4e} (logits max "
          f"abs {float(np.abs(f32).max()):.4e})")
    del ims, models, q
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, __file__, "--profile-recurrent"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"--profile-recurrent exited {child.returncode}: "
             f"{child.stderr[-2000:]}")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    if prof["unplaced"]:
        fail(f"profile: {len(prof['unplaced'])} device events outside the "
             f"ranges: {prof['unplaced'][:8]}")
    for name, o in prof["profile"].items():
        print(f"profile {name} (torch.profiler): {o['launches']} device "
              f"kernels, {o['copies']} copies, device busy "
              f"{o['busy_ms']:.4f} ms (kernel durations summed "
              f"{o['sum_ms']:.4f}) of {o['wall_ms']:.4f} ms wall, idle "
              f"share {o['idle_share']:.4f}; by kind (count, ms) "
              f"{o['top']} ({card})")
    for name in ("lstm_request", "gru_request"):
        if prof["profile"][name]["launches"] < 500:
            fail(f"profile {name}: {prof['profile'][name]} — fewer device "
                 "kernels than timesteps")
    return prof["profile"]


def greedy_margins(torch, m, enc, start, steps):
    """Seq2seq's greedy decode of ``enc`` on its device: the tokens and, per
    row and step, the top-2 logit margin the choice was made by."""
    p = m.get_variables()["params"]
    ids = torch.from_numpy(enc).to(m._device())
    toks, margins = [], []
    with torch.inference_mode():
        carries = m.prefill(p, ids)
        tok = torch.full((len(enc),), start, dtype=torch.int32,
                         device=ids.device)
        for _ in range(steps):
            x = m.embedding.call(p[m.embedding.name], tok[:, None])
            new = []
            for dec, carry in zip(m.decoder_rnns, carries):
                x, nc = dec.run(p[dec.name], x, initial_carry=carry)
                new.append(nc)
            carries = tuple(new)
            logits = m.generator.call(p[m.generator.name], x[:, 0])
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
    return (torch.stack(toks, 1).cpu().numpy(),
            torch.stack(margins, 1).cpu().numpy())


def useful(row, budget, stop=GEN_STOP):
    """Tokens a client wanted: cut at the budget and after the first stop
    token (bench_serving_generative's accounting)."""
    row = [int(t) for t in row[:budget]]
    return row[:row.index(stop) + 1] if stop in row else row


def held_to_infer(what, got, row, margins, budget):
    """``got`` against ``useful(row, budget)`` up to the first step whose
    margin is below GEN_MARGIN; returns the steps compared."""
    want = useful(row, budget)
    clear = next((k for k, mg in enumerate(margins[:len(want)])
                  if mg < GEN_MARGIN), len(want))
    if clear == len(want):
        ok = got == want
    else:
        ok = got[:clear] == want[:clear]
    if not ok:
        fail(f"{what}: served tokens {got} != infer's {want} (clear steps "
             f"{clear})")
    return clear


def generative_phase(torch, card):
    """Phase 11: Seq2seq at ``bench_serving_generative``'s configuration:
    ``infer`` early exit against scan-then-mask, the 64 requests through
    ``ServingEngine.register_generative`` held to ``infer`` under float32
    products, the scheduler's rates and latencies beside the naive
    whole-sequence path under the default policy, one streamed
    ``ServingHttpClient.generate`` and one Redis generative record through
    ``ClusterServing``."""
    from analytics_zoo_torch.observability import get_registry
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.serving.client import (
        InputQueue, OutputQueue, ServingHttpClient)
    from analytics_zoo_torch.serving.engine import Request, ServingEngine
    from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
    from analytics_zoo_torch.serving.server import (
        ClusterServing, ServingConfig)
    m, enc, budgets = seq2seq_model(torch)
    kw = dict(start_sign=GEN_START, max_seq_len=GEN_MAX_LEN,
              stop_sign=GEN_STOP)
    kernels.reset_launch_counts()
    fast, steps = m.infer(enc, return_steps=True, **kw)
    naive = m.infer(enc, early_exit=False, **kw)
    if not np.array_equal(fast, naive) or not 1 <= steps <= GEN_MAX_LEN:
        fail(f"seq2seq infer early exit ({steps} steps) differs from "
             "scan-then-mask")
    print(f"seq2seq infer (64 x 12 -> 32 tokens): early exit identical to "
          f"scan-then-mask, {steps} steps of {GEN_MAX_LEN}; rows holding "
          f"the stop token {int((fast == GEN_STOP).any(1).sum())}")

    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    rows, margins = greedy_margins(torch, m, enc, GEN_START, GEN_MAX_LEN)
    if not np.array_equal(rows, m.infer(enc, start_sign=GEN_START,
                                        max_seq_len=GEN_MAX_LEN)):
        fail("seq2seq: the margin walk and infer disagree")
    eng = ServingEngine()
    ep = eng.register_generative(
        "gen", m, enc_len=GEN_ENC_LEN, start_sign=GEN_START,
        stop_sign=GEN_STOP, max_seq_len=GEN_MAX_LEN, slots=GEN_SLOTS)
    warmed = ep.warm()
    if warmed != 2 * len(ep.pool.buckets):
        fail(f"generative warm ran {warmed} rungs, want "
             f"{2 * len(ep.pool.buckets)}")
    reqs = [Request(endpoint="gen", uri=f"g{i}", data=enc[i],
                    max_tokens=int(budgets[i])) for i in range(GEN_REQUESTS)]
    eng.wait_all(eng.submit(reqs), timeout_s=600)
    eng.stop()
    covered = total = 0
    for i, r in enumerate(reqs):
        if r.error is not None:
            fail(f"generative request g{i}: {r.error!r}")
        covered += held_to_infer(f"generative request g{i}", r.result,
                                 rows[i], margins[i], budgets[i])
        total += len(useful(rows[i], budgets[i]))
    print(f"generative engine vs infer (float32 products): 64 requests, "
          f"{covered} of {total} useful tokens compared (up to each row's "
          f"first top-2 margin below {GEN_MARGIN}), all equal; smallest "
          f"margin {float(margins.min()):.3e}; warm ran {warmed} rungs")

    broker = EmbeddedBroker()
    serving = ClusterServing(None, ServingConfig(
        batch_size=GEN_SLOTS, consumer_group="g", http_port=0,
        metrics_host="127.0.0.1"), broker=broker)
    serving.register_generative_endpoint(
        "chat", m, enc_len=GEN_ENC_LEN, start_sign=GEN_START,
        stop_sign=GEN_STOP, max_seq_len=GEN_MAX_LEN)
    loop = serving.start_background()
    deadline = time.perf_counter() + 120
    while serving.http_transport.port is None:
        if time.perf_counter() > deadline:
            fail("ClusterServing's HTTP transport did not start")
        time.sleep(0.01)
    streamed = []
    doc = ServingHttpClient(serving.http_transport.url).generate(
        "chat", enc[0], on_token=lambda i, t: streamed.append(t))
    if doc["tokens"] != streamed:
        fail(f"/generate streamed {streamed}, final {doc['tokens']}")
    n_http = held_to_infer("/generate", doc["tokens"], rows[0], margins[0],
                           GEN_MAX_LEN)
    InputQueue(broker=broker).enqueue(
        "gen-redis", enc[1], endpoint="chat", max_tokens=5)
    res = OutputQueue(broker=broker).query("gen-redis", timeout_s=120)
    if not isinstance(res, list) or len(res) > 5:
        fail(f"redis generative record: result {res}")
    n_redis = held_to_infer("redis generative record", res, rows[1],
                            margins[1], 5)
    serving.stop()
    loop.join(60)
    if loop.is_alive():
        fail("ClusterServing.run did not stop")
    print(f"ClusterServing generative: /generate streamed {len(streamed)} "
          f"tokens ({n_http} compared with infer), the Redis record "
          f"(max_tokens 5) got {res} ({n_redis} compared)")
    dtypes.restore_policy(default)

    # ---- naive whole-sequence decode against the scheduler, as
    # bench_serving_generative reads them (default policy)
    m.infer(enc[:GEN_SLOTS], early_exit=False, **kw)
    naive_gaps, naive_first, naive_tokens = [], [], 0
    t0 = time.perf_counter()
    for lo in range(0, GEN_REQUESTS, GEN_SLOTS):
        out = m.infer(enc[lo:lo + GEN_SLOTS], early_exit=False, **kw)
        done = time.perf_counter()
        for row, budget in zip(out, budgets[lo:lo + GEN_SLOTS]):
            toks = useful(row, budget)
            naive_tokens += len(toks)
            # the whole sequence lands when its batch completes
            naive_first.append(done - t0)
            naive_gaps.append(done - t0)
            naive_gaps.extend([0.0] * (len(toks) - 1))
    naive_wall = time.perf_counter() - t0
    naive_steps = -(-GEN_REQUESTS // GEN_SLOTS) * GEN_MAX_LEN

    eng = ServingEngine()
    ep = eng.register_generative(
        "chat", m, enc_len=GEN_ENC_LEN, start_sign=GEN_START,
        stop_sign=GEN_STOP, max_seq_len=GEN_MAX_LEN, slots=GEN_SLOTS)
    ep.warm()
    eng.start()
    times = {i: [] for i in range(GEN_REQUESTS)}
    # host time inside the pool's two calls (admit: the prefill, queued;
    # step_once: the step and its one read of the tokens)
    spent = Counter()

    def timed(name, fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[name] += time.perf_counter() - t
                spent[name + " calls"] += 1
        return run
    ep.pool.admit = timed("admit", ep.pool.admit)
    ep.pool.step_once = timed("step_once", ep.pool.step_once)

    def on_token(i):
        return lambda _idx, _tok: times[i].append(time.perf_counter())
    t0 = time.perf_counter()
    reqs = [Request(endpoint="chat", uri=f"t{i}", data=enc[i],
                    max_tokens=int(budgets[i]), on_token=on_token(i))
            for i in range(GEN_REQUESTS)]
    eng.wait_all(eng.submit(reqs), timeout_s=600)
    sched_wall = time.perf_counter() - t0
    iterations = ep.pool.iterations
    occupancy = get_registry().gauge(
        "serving_slot_occupancy", "active decode slots / pool capacity",
        labels=("endpoint",)).labels("chat").value
    eng.stop()
    if any(r.error is not None for r in reqs):
        fail("generative timing run: a request failed")
    sched_tokens = sum(len(r.result) for r in reqs)
    gaps, first = [], []
    for i in range(GEN_REQUESTS):
        first.append(times[i][0] - t0)
        gaps.append(times[i][0] - t0)
        gaps.extend(np.diff(times[i]).tolist())

    def pct(v, p):
        return float(np.percentile(v, p) * 1e3)
    print(f"generative scheduler (64 requests, 16 slots, bf16 products): "
          f"{sched_tokens} useful tokens in {sched_wall * 1e3:.3f} ms, "
          f"{sched_tokens / sched_wall:.1f} tokens/s; {iterations} decode "
          f"iterations against the naive {naive_steps}; mean occupancy "
          f"{sched_tokens / (iterations * GEN_SLOTS):.4f}, final slot "
          f"occupancy {occupancy:.4f}; inter-token p50 {pct(gaps, 50):.3f} "
          f"p99 {pct(gaps, 99):.3f} ms; first token p50 "
          f"{pct(first, 50):.3f} p99 {pct(first, 99):.3f} ms; host "
          f"{sched_wall * 1e3 / iterations:.4f} ms an iteration, of which "
          f"{spent['admit calls']} admit (prefill) calls "
          f"{spent['admit'] * 1e3:.3f} ms and {spent['step_once calls']} "
          f"step_once calls {spent['step_once'] * 1e3:.3f} ms ({card})")
    p = m.get_variables()["params"]
    ids = torch.from_numpy(enc).to(m._device())
    with torch.inference_mode():
        carries = m.prefill(p, ids[:GEN_SLOTS])
        tok = torch.full((GEN_SLOTS,), GEN_START, dtype=torch.int32,
                         device=ids.device)
        parts = {
            "prefill of 1 row": lambda: m.prefill(p, ids[:1]),
            "prefill of 16 rows": lambda: m.prefill(p, ids[:GEN_SLOTS]),
            "decode_step of 16 lanes": lambda: m.decode_step(p, tok,
                                                             carries)}
        for what, fn in parts.items():
            fn()
            host = statistics.median(sync_host_ms(torch, fn)
                                     for _ in range(10))
            print(f"seq2seq {what}: {host:.4f} ms (host clock to a "
                  f"synchronize, median of 10; {card})")
    print(f"generative naive whole-sequence infer (4 batches of 16 x 32 "
          f"steps): {naive_tokens} useful tokens in {naive_wall * 1e3:.3f} "
          f"ms, {naive_tokens / naive_wall:.1f} tokens/s; {naive_steps} "
          f"decode iterations; inter-token p50 {pct(naive_gaps, 50):.3f} "
          f"p99 {pct(naive_gaps, 99):.3f} ms; first token p50 "
          f"{pct(naive_first, 50):.3f} p99 {pct(naive_first, 99):.3f} ms "
          f"({card})")
    if sum(kernels.launch_counts().values()):
        fail(f"the generative path launched a kernel "
             f"{kernels.launch_counts()}: its path has none")


def session_phase(torch, card):
    """Phase 12: SessionRecommender at its class defaults over
    MovieLens-1M's 3706 items: ``predict`` timed and
    ``recommend_for_session`` on 1024 sessions, card against CPU."""
    from analytics_zoo_torch.models.recommendation import SessionRecommender
    from analytics_zoo_torch.pipeline.api.keras.layers import Embedding
    m = SessionRecommender(item_count=SESSION_ITEMS)
    m.model.init(torch.Generator().manual_seed(0))
    spread_logits(m.get_variables()["params"],
                  next(l.name for l in m.model.layers
                       if isinstance(l, Embedding)),
                  m.model.outputs[0].node.layer.name)
    sessions = np.random.RandomState(5).randint(
        1, SESSION_ITEMS + 1, (1024, 5))
    rec = m.recommend_for_session(sessions, max_items=5)
    logits = cpu_forward(torch, m.model, [sessions.astype(np.int32)])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)[:, :6]
    compared = 0
    worst = 0.0
    for s, (row, top) in enumerate(zip(rec, order)):
        p = probs[s, top]
        for k, (item, prob) in enumerate(row):
            worst = max(worst, abs(prob - float(p[k])))
            apart = all(abs(p[k] - p[j]) > RANK_GAP
                        for j in range(6) if j != k)
            if apart:
                compared += 1
                if item != int(top[k]):
                    fail(f"session {s}: card top-5 {row} vs CPU "
                         f"{list(zip(top[:5].tolist(), p[:5].tolist()))}")
    lat = []
    x = [sessions.astype(np.int32)]
    m.predict(x, batch_size=1024)
    for _ in range(8):
        s0 = time.perf_counter()
        m.predict(x, batch_size=1024)
        lat.append((time.perf_counter() - s0) * 1e3)
    print(f"session recommender (3706 items, 1024 sessions of 5): card top-5 "
          f"equal to the CPU's at {compared} of {5 * len(rec)} ranks (the "
          f"rest within {RANK_GAP} of a neighbour), probabilities max abs "
          f"diff {worst:.3e}; predict median {statistics.median(lat):.3f} "
          f"ms over {[round(t, 3) for t in lat]} ({card})")


# --------------------------------------- phase 13: image classification
# The JAX ResNet bench's configuration (benchmarks/resnet.py:28-56).
IMG = (224, 224, 3)
IMG_CLASSES = 1000
RESNET_BATCH = 128
RESNET_UNTIMED = 3
RESNET_TIMED = 10
SERVE_BATCH = 32
# Card against CPU logits under float32 (TF32 off, zoo_context.py): cuDNN
# and the CPU's convolutions sum each window in other orders (~1e-7
# relative a convolution), carried through 53 convolutions.
IMG_F32_RTOL = 1e-4
# top-5 classes compared where a logit lies further than this share of
# the largest logit from its neighbours (below it the order may flip on
# that float32 noise)
TOP5_GAP = 1e-4
# the dense bf16 tensor-core peak of one H100 SXM at 700 W (NVIDIA data
# sheet), for the step's FLOP share
BF16_FLOPS_PER_S = 989e12


def bench_sgd():
    """``benchmarks/resnet.py``'s optimizer."""
    from analytics_zoo_torch.pipeline.api.keras.optimizers import (
        SGD, poly, warmup_then)
    return SGD(learning_rate=0.1, momentum=0.9, schedule=warmup_then(
        0.1, 5, poly(0.1, 0.5, max_iteration=10_000)))


def resnet_model(torch):
    """``resnet(50, 1000 classes, 224x224x3, stem="space_to_depth")``
    with seeded random weights: the net ``run_resnet_bench`` trains."""
    from analytics_zoo_torch.models.image import resnet
    m = resnet(50, num_classes=IMG_CLASSES, input_shape=IMG,
               stem="space_to_depth")
    m.init(torch.Generator().manual_seed(0))
    return m


def step_flops(model, batch) -> float:
    """FLOPs of one training step, from the layers' shapes: 2 N Ho Wo Kh
    Kw Cin/groups Cout a convolution and 2 N in out a Dense, x3 for the
    forward and the backward (the other layers' elementwise work is left
    out)."""
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        Convolution2D, Dense)
    total = 0
    for node in model._topo:
        layer, out = node.layer, node.outputs[0].shape
        cin = node.inbound[0].shape[-1]
        if isinstance(layer, Convolution2D):
            kh, kw = layer.kernel_size
            total += 2 * batch * out[1] * out[2] * kh * kw * \
                cin // layer.groups * out[3]
        elif isinstance(layer, Dense):
            total += 2 * batch * cin * out[-1]
    return 3.0 * total


def resnet_train_steps(torch, model, batch, mode, n_untimed, n_timed):
    """``n_untimed`` then ``n_timed`` steps of ``train_step`` under
    ``ops.fused=mode`` from the model's variables, each ended by
    ``torch.cuda.synchronize()``: (timed ms, last loss, final state)."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    get_config().set("ops.fused", mode)
    try:
        tr = DistributedTrainer(model, objectives.get(
            "sparse_categorical_crossentropy_with_logits"),
            optim_method=bench_sgd())
        v = model.get_variables()
        params = tr.place_params(v["params"])
        state = tr.replicate(v["state"])
        opt_state = tr.init_opt_state(params)
        out = []
        for i in range(n_untimed + n_timed):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            params, opt_state, state, loss = tr.train_step(
                params, opt_state, state, batch, None)
            torch.cuda.synchronize()
            if i >= n_untimed:
                out.append((time.perf_counter() - s0) * 1e3)
        return out, float(loss), state
    finally:
        get_config().set("ops.fused", "auto")
        # the trainer's captured step (its graph pool) goes with the turn
        tr = params = opt_state = None
        import gc
        gc.collect()
        torch.cuda.empty_cache()


def image_serving(torch, card):
    """13a: ``ImageClassifier("resnet-50")`` served through
    ``InferenceModel``: latency and images/s at batch 32 under bf16 and
    float32 products in turns, card against CPU logits under float32,
    ``predict_image_classes`` through an ``ImageSet``."""
    from analytics_zoo_torch.feature.image import (
        ImageCenterCrop, ImageChannelNormalize, ImageSet)
    from analytics_zoo_torch.models.image import (
        ImageClassifier, ImageConfigure)
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    m = ImageClassifier("resnet-50", num_classes=IMG_CLASSES,
                        input_shape=IMG, config=ImageConfigure(
                            preprocessor=ImageCenterCrop(*IMG[:2]) >>
                            ImageChannelNormalize(123.0, 117.0, 104.0,
                                                  58.4, 57.1, 57.4)))
    m.model.init(torch.Generator().manual_seed(0))
    im = InferenceModel().load_zoo(m)
    x = np.random.RandomState(13).randn(SERVE_BATCH, *IMG).astype(
        np.float32)
    shape = "x".join(map(str, IMG))
    default = dtypes.get_policy()
    policies = {"bf16": lambda: dtypes.restore_policy(default),
                "float32": lambda: dtypes.set_policy("float32", "float32")}
    kernels.reset_launch_counts()
    lat = {k: [] for k in policies}
    for name in ("bf16", "float32", "float32", "bf16"):
        policies[name]()
        im.predict(x, batch_size=SERVE_BATCH)
        for _ in range(5):
            s0 = time.perf_counter()
            out = im.predict(x, batch_size=SERVE_BATCH)   # host numpy
            lat[name].append((time.perf_counter() - s0) * 1e3)
        if out.shape != (SERVE_BATCH, IMG_CLASSES) or \
                not np.isfinite(out).all():
            fail(f"resnet-50 predict ({name}) output shape {out.shape}")
    if sum(kernels.launch_counts().values()):
        fail(f"ResNet-50 predict launched a kernel "
             f"{kernels.launch_counts()}: its path has none")
    for name, v in lat.items():
        med = statistics.median(v)
        print(f"resnet-50 predict, batch {SERVE_BATCH} x {shape}, {name} "
              f"products, in turns: median {med:.3f} ms over "
              f"{[round(t, 3) for t in v]}, {SERVE_BATCH * 1e3 / med:.1f} "
              f"images/s ({card})")
    # card against CPU, float32 products
    policies["float32"]()
    got = im.predict(x[:2], batch_size=2)
    want = cpu_forward(torch, m.model, x[:2])
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"resnet-50 card vs CPU logits (2 images, float32 products): "
          f"relative L2 {err:.3e} (tolerance {IMG_F32_RTOL}), logits max "
          f"abs {float(np.abs(want).max()):.3e}")
    if not err <= IMG_F32_RTOL:
        fail(f"resnet-50 card and CPU logits differ: relative L2 {err}")
    # predict_image_classes through an ImageSet, card against CPU
    side = IMG[0] + 32
    raw = np.random.RandomState(14).randint(0, 256, (8, side, side, 3)).astype(
        np.uint8)
    images = ImageSet.from_ndarrays(raw)
    top = m.predict_image_classes(images, top_k=5)
    batch = np.stack(images.transform(m.config.preprocessor).images)
    logits = cpu_forward(torch, m.model, batch.astype(np.float32))
    order = np.argsort(-logits, axis=-1)[:, :6]
    compared = 0
    for r, (row, ref) in enumerate(zip(top, order)):
        scale = float(np.abs(logits[r]).max())
        for k in range(5):
            gaps = [abs(logits[r, ref[k]] - logits[r, ref[j]])
                    for j in range(6) if j != k]
            if min(gaps) > TOP5_GAP * scale:
                compared += 1
                if int(row[k]) != int(ref[k]):
                    fail(f"image {r}: card top-5 {list(row)} vs CPU "
                         f"{list(ref[:5])}")
    print(f"resnet-50 predict_image_classes (8 images {side}x{side} through "
          f"ImageCenterCrop + ImageChannelNormalize, float32 products): card "
          f"top-5 equal to the CPU's at {compared} of 40 ranks compared (the "
          f"rest within {TOP5_GAP} of the largest logit of a neighbour)")
    dtypes.restore_policy(default)
    del im, m
    torch.cuda.empty_cache()


def image_phase(torch, card, dev):
    """Phase 13: ResNet-50 served (13a), trained at the bench's
    configuration through ``train_step`` in turns with ``ops.fused=torch``
    (13b), through ``fit`` (13c), its 161-leaf SGD update held and timed
    (13d), and profiled in a child process (13e).  Returns the launches of
    the timed ``auto`` steps, the SGD check's errors and its times."""
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_map)
    image_serving(torch, card)
    # ---- 13b: training at the bench's configuration
    dtypes.restore_policy(None)
    if dtypes.get_policy().compute_dtype != torch.bfloat16:
        fail("the default policy is not bf16 compute over float32 params")
    model = resnet_model(torch)
    start = tree_map(torch.clone, model.get_variables())
    leaves = tree_leaves(start["params"])
    n_params = sum(int(p.numel()) for p in leaves)
    gen = torch.Generator(device=dev).manual_seed(13)
    batch = (torch.randn((RESNET_BATCH,) + IMG, generator=gen, device=dev),
             torch.randint(0, IMG_CLASSES, (RESNET_BATCH,), generator=gen,
                           device=dev))
    flops = step_flops(model, RESNET_BATCH)
    shape = "x".join(map(str, IMG))
    print(f"resnet-50 (space_to_depth stem, 1000 classes): {n_params} params "
          f"in {len(leaves)} float32 leaves, "
          f"{len(tree_leaves(start['state']))} BN statistics; a training "
          f"step of {RESNET_BATCH} x {shape} is {flops:.4e} FLOP "
          f"(convolutions and the Dense, forward x3)")
    steps = {"auto": [], "torch": []}
    torch.cuda.reset_peak_memory_stats()
    for mode in ("auto", "torch", "torch", "auto"):
        kernels.reset_launch_counts()
        ms, loss, state = resnet_train_steps(torch, model, batch, mode,
                                             RESNET_UNTIMED, RESNET_TIMED)
        launches = kernels.launch_counts()
        n = RESNET_UNTIMED + RESNET_TIMED
        want = {"fused_sgd": n if mode == "auto" else 0}
        expect_launches(launches, want, f"resnet-50 train_step ({mode})")
        if not np.isfinite(loss):
            fail(f"resnet-50 step loss {loss} under ops.fused={mode}")
        moved = sum(not torch.equal(a, b) for a, b in zip(
            tree_leaves(state), tree_leaves(start["state"])))
        if moved != len(tree_leaves(start["state"])):
            fail(f"resnet-50: {moved} of 106 BN statistics changed")
        steps[mode] += ms
        if mode == "auto":
            train_launches = launches
    peak = torch.cuda.max_memory_allocated()
    for mode, v in steps.items():
        med = statistics.median(v)
        print(f"resnet-50 training step ops.fused={mode}, batch "
              f"{RESNET_BATCH} x {shape}, bf16 products, bench SGD: median "
              f"{med:.3f} ms (min {min(v):.3f}, max {max(v):.3f}) over "
              f"{[round(t, 3) for t in v]}, {RESNET_BATCH * 1e3 / med:.1f} "
              f"images/s, {flops / (med * 1e-3) / 1e12:.2f} TFLOP/s = "
              f"{flops / (med * 1e-3) / BF16_FLOPS_PER_S:.4f} of the dense "
              f"bf16 peak 989 TFLOP/s ({card})")
    print(f"resnet-50 training: last loss {loss:.5f}, all 106 BN statistics "
          f"moved, launches of a turn of {RESNET_UNTIMED + RESNET_TIMED} "
          f"steps {train_launches}; torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; after the turns allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    # ---- 13c: the normal entry point, fit on host numpy data
    model.set_variables(tree_map(torch.clone, start))
    model.compile(bench_sgd(), "sparse_categorical_crossentropy_with_logits")
    rs = np.random.RandomState(15)
    hx = rs.randn(2 * 64, *IMG).astype(np.float32)
    hy = rs.randint(0, IMG_CLASSES, 2 * 64).astype(np.int64)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = model.fit(hx, hy, batch_size=64, nb_epoch=1, rng=0)
    fit_s = time.perf_counter() - t0
    fit_launches = kernels.launch_counts()
    expect_launches(fit_launches, {"fused_sgd": 2}, "resnet-50 fit")
    after = tree_leaves(model.get_variables()["state"])
    moved = sum(not torch.equal(a, b) for a, b in zip(
        after, tree_leaves(start["state"])))
    if not np.isfinite(history[0]["loss"]) or moved != len(after):
        fail(f"resnet-50 fit: history {history}, {moved} statistics moved")
    print(f"resnet-50 fit: 2 steps of 64 on host numpy in {fit_s:.3f} s "
          f"(first epoch, warm-up included), loss "
          f"{history[0]['loss']:.5f}, launches {fit_launches}; moving "
          f"statistics changed by fit: {moved} of {len(after)}")
    del model, batch, hx
    torch.cuda.empty_cache()
    # ---- 13d: the SGD kernel at ResNet-50's 161 leaves
    errs = opt_leaves_check(torch, leaves, "ResNet-50")
    times = time_updates(torch, leaves, card, "ResNet-50")
    del start, leaves
    torch.cuda.empty_cache()
    # ---- 13e: one training step and one predict profiled
    child = subprocess.run([sys.executable, __file__, "--profile-resnet"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"--profile-resnet exited {child.returncode}: "
             f"{child.stderr[-2000:]}")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    if prof["unplaced"]:
        fail(f"profile: {len(prof['unplaced'])} device events outside the "
             f"ranges: {prof['unplaced'][:8]}")
    for name, o in prof["profile"].items():
        print(f"profile {name} (torch.profiler): {o['launches']} device "
              f"kernels, {o['copies']} copies, device busy "
              f"{o['busy_ms']:.4f} ms (kernel durations summed "
              f"{o['sum_ms']:.4f}) of {o['wall_ms']:.4f} ms wall, idle share "
              f"{o['idle_share']:.4f}; by group (group, count, ms) "
              f"{o['by_kind']} ({card})")
    step = prof["profile"]["resnet50_train_step"]["by_kind"]
    if [c for g, c, _ in step if g == "sgd"] != [1]:
        fail(f"profile: the training step ran {step}, want one multi_sgd")
    return train_launches, errs, times


# what a ResNet device kernel is, read from its name: the first group
# whose words it holds
RESNET_GROUPS = (
    ("sgd", ("multi_sgd",)),
    ("copies", ("Memcpy", "Memset")),
    ("layout", ("nchwToNhwc", "nhwcToNchw", "Nhwc2Nchw", "Nchw2Nhwc",
                "convertTensor", "transpose")),
    ("pooling", ("pool", "Pool")),
    ("convolution", ("conv", "Conv", "cudnn", "xmma", "implicit", "wgrad",
                     "dgrad", "fprop", "sm90", "nvjet", "gemm", "Gemm")),
    ("reductions", ("reduce", "Reduce")),
    # PyTorch's elementwise kernel for operands it cannot vectorize
    # (broadcast or strided)
    ("elementwise, not vectorized", ("native::elementwise_kernel",)),
    ("elementwise", ("elementwise", "Elementwise", "copy", "fill",
                     "where", "clamp")),
)


def resnet_group(name: str) -> str:
    return next((g for g, words in RESNET_GROUPS
                 if any(w in name for w in words)), "other")


def profile_resnet() -> None:
    """``--profile-resnet``: in a process of its own (one
    ``torch.profiler`` session a process), one ResNet-50 training step at
    the bench's configuration (``train_step``, batch 128, bf16 products)
    and one ``InferenceModel.predict`` of 32 images, each in a
    ``record_function`` range that ends with a synchronize, after warm-up
    steps.  Prints one JSON line: per range the device kernels, copies,
    device busy ms, wall ms, idle share and device ms by group
    (``RESNET_GROUPS``)."""
    import torch

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    ctx = init_zoo_context(device="cuda:0")
    dev = ctx.device
    model = resnet_model(torch)
    tr = DistributedTrainer(model, objectives.get(
        "sparse_categorical_crossentropy_with_logits"),
        optim_method=bench_sgd())
    v = model.get_variables()
    params = tr.place_params(v["params"])
    st = {"state": tr.replicate(v["state"]),
          "opt": tr.init_opt_state(params)}
    gen = torch.Generator(device=dev).manual_seed(13)
    batch = (torch.randn((RESNET_BATCH,) + IMG, generator=gen, device=dev),
             torch.randint(0, IMG_CLASSES, (RESNET_BATCH,), generator=gen,
                           device=dev))

    def train_step():
        _, st["opt"], st["state"], _ = tr.train_step(
            params, st["opt"], st["state"], batch, None)

    im = InferenceModel().load_zoo(model)
    x = np.random.RandomState(13).randn(SERVE_BATCH, *IMG).astype(
        np.float32)
    runs = {"resnet50_train_step": train_step,
            "resnet50_predict_32": lambda: im.predict(
                x, batch_size=SERVE_BATCH)}
    for fn in runs.values():
        for _ in range(3):
            fn()
    out, unplaced = profile_ranges(torch, runs, resnet_group)
    print(json.dumps({"profile": out, "unplaced": unplaced}))


# --------------------------- phase 14: the flash kernels on bfloat16
# where the bf16 kernels are checked: a ragged last tile at head_dim 64,
# head_dim 128, fewer rows than one 64-row tile, and bench_attention's
# shape
BF16_SHAPES = ((2, 4, 200, 64), (2, 4, 512, 128), (1, 2, 17, 128),
               (4, 8, 4096, 128))
# and the forward alone where T is 1, one row either side of its 128-row
# query block and 128-key tile, and long at head_dim 64
BF16_FWD_SHAPES = ((1, 2, 1, 64), (1, 2, 1, 128), (2, 3, 127, 128),
                   (2, 3, 129, 64), (2, 3, 129, 128), (1, 2, 4096, 64))
BF16_BENCH = (4, 8, 4096, 128)
# Kernel against plain version, both on the card from the same bf16 inputs.
# O: the forward kernel rounds P to bf16 at each 128-key tile's running
# max, the plain version at the row's max, and both round O to bf16 once.
# So an element may land one bf16 ulp apart (at most 2^-7 of it), and the
# two roundings of P leave a difference that scales with the row's values,
# not with the element's: 2^-6 of the row's RMS in the plain version's O.
BF16_O_RTOL, BF16_O_ROW_RMS = 2.0 ** -7, 2.0 ** -6
# On inputs where key 0 holds every row's largest score, the kernel's
# running max is the row's max from its first tile on, so both round P
# alike: O may differ only where float32 sums in other orders tip S, P or
# O to the next value, on at most this share of its elements, each within
# the tolerance above.  That share grows with the keys a row sums: 0.07%
# to 0.12% at 200 keys, 0.28% to 0.44% at 512 and 1.6% at 4096 on the
# H100.  Rounding S to bf16 before the softmax (the plain version's former
# order) or not rounding P moves 17% to 60% of the elements there.
BF16_O_TIPPED_SHARE = 0.05
# LSE is float32 on both sides from the same exact bf16 products, summed in
# another order (the tensor core's accumulation against cuBLAS's float32
# product) over up to 4096 keys: 9.5e-7 at most measured on the H100
BF16_LSE_ATOL = 1e-5
# dQ, dK, dV: float32 sums on both sides (the kernels' float32 operands as
# three bf16 parts, ~2^-24 of each term dropped) in other orders, each
# rounded to bf16 once: one bf16 ulp apart at most (2^-7 of the value);
# where dS = P (dP - delta) cancels to near zero, 2^-10 of the tensor's
# largest element, and 1e-5 where it is zero in exact arithmetic (a row of
# one key: dP and delta, float32 sums of the same bf16 products in other
# orders, leave ~1e-7)
BF16_BWD_RTOL, BF16_BWD_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10
BF16_BWD_ATOL_FLOOR = 1e-5


def o_used(got, want) -> float:
    """The largest share of its tolerance an element of O uses: one bf16
    ulp (rtol 2^-7) plus 2^-6 of the row's RMS in the plain version's O."""
    got, want = got.float(), want.float()
    row_atol = BF16_O_ROW_RMS * want.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got - want).abs() / (
        row_atol + BF16_O_RTOL * want.abs())).max())


def o_close(name, got, want) -> tuple:
    """O of the bf16 forward against the plain version's: fails past its
    tolerance (``o_used``); returns the largest abs error and the largest
    share of its tolerance an element used."""
    used = o_used(got, want)
    err = float((got.float() - want.float()).abs().max())
    if not used <= 1.0:
        fail(f"{name}: max abs err {err:.3e}, {used:.3f} of its tolerance "
             f"(rtol {BF16_O_RTOL}, atol {BF16_O_ROW_RMS} x the row's RMS)")
    return err, used


def leading_key_inputs(torch, shape, gen, dev):
    """bf16 q, k, v of ``shape`` on which key 0 holds every row's largest
    score by a wide margin (score +2.5 at head_dim 64, +1.8 at 128, against
    the others' 0 down to -4.3 / -3.0, with noise of 0.1): coordinate 0 of
    q is 2, of k uniform in [-17, 0] and 10 at key 0; the other
    coordinates of q are N(0, 0.01), of k and v N(0, 1)."""
    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)
    q = 0.1 * randn(*shape)
    q[..., 0] = 2.0
    k = randn(*shape)
    k[..., 0] = -17.0 * torch.rand(shape[:-1], generator=gen, device=dev)
    k[..., 0, 0] = 10.0
    return [x.to(torch.bfloat16) for x in (q, k, randn(*shape))]


def o_tipped(got, want) -> tuple:
    """The share of O's elements on which ``got`` is not ``want``, and the
    largest share of its tolerance (``o_used``) an element uses."""
    return float((got != want).float().mean()), o_used(got, want)


def o_fault2_order(torch, q, k, v, causal):
    """Control: O in the plain version's former order, which rounds S, P,
    P.V and O to bf16 (a product of two bf16 tensors)."""
    t = q.shape[2]
    s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2)).float()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p.to(v.dtype), v).float() / l_safe).to(q.dtype)


def o_unrounded_p(torch, q, k, v, causal):
    """Control: O in the reference's order but with P kept in float32."""
    from analytics_zoo_torch.ops.flash_attention import q_scale
    t = q.shape[2]
    qs = (q.float() * q_scale(q.shape[-1] ** -0.5, q.dtype)).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, v.float()) / l_safe).to(q.dtype)


def flash_bf16_bound(shape, causal, passes, tensors_moved, rows):
    """The least time of a bf16 flash kernel: ``passes`` T x T products of
    depth D over the (causal: T^2/2) query-key pairs at the bf16 peak,
    against ``tensors_moved`` (B, H, T, D) bf16 tensors and ``rows``
    float32 values a query (LSE; LSE and delta) at the memory rate, each
    read or written once.  A product with one float32 operand counts three
    passes: three bf16 parts (the kernels' way, 3/989 against split TF32's
    2/495)."""
    b, h, t, d = shape
    pairs = t * t / 2 if causal else t * t
    flops = passes * 2 * b * h * pairs * d
    moved = tensors_moved * b * h * t * d * 2 + rows * b * h * t * 4
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_backend(torch, q, k, v) -> str:
    """The backend PyTorch picks for scaled_dot_product_attention on these
    inputs, causal."""
    from torch.nn.attention import SDPBackend
    choice = int(torch._fused_sdp_choice(q, k, v, is_causal=True))
    for name, member in SDPBackend.__members__.items():
        if int(member) == choice:
            return name
    return f"backend {choice}"


# the (batch, head) slices checked at twice bench_attention's sequence,
# where the plain versions' float32 (T, T) tensors of all 32 heads would
# take 8.6 GB each
BF16_2X_HEADS = ((0, 0), (1, 5), (3, 7))


def check_bf16_heads(torch, fa, q, k, v, do, o, lse, delta, bwd_close):
    """The three bf16 kernels run on the whole causal (B, H, T, D) inputs,
    held head by head against the plain versions on the same head's
    slices (heads are independent) at ``BF16_2X_HEADS``; returns each
    kernel's largest abs error."""
    from analytics_zoo_torch.ops.flash_attention import KERNELS
    names = KERNELS[torch.bfloat16]
    heads = q.shape[1]
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, True)
    errs = dict.fromkeys(names, 0.0)
    for b, h in BF16_2X_HEADS:
        tag = f"{tuple(q.shape)} causal=True, head ({b}, {h})"
        bh = b * heads + h
        one = [x[b:b + 1, h:h + 1] for x in (q, k, v, do)]
        lse1, delta1 = lse[bh:bh + 1], delta[bh:bh + 1]
        o_ref, lse_ref = fa.flash_attention_ref(*one[:3], causal=True)
        err_o, used_o = o_close(f"bf16 forward {tag} O",
                                o[b:b + 1, h:h + 1], o_ref)
        err_l = close(f"bf16 forward {tag} LSE", lse1, lse_ref, BF16_LSE_ATOL)
        del o_ref, lse_ref
        want = (fa.flash_attention_dq_ref(*one, lse1, delta1, True),
                *fa.flash_attention_dkv_ref(*one, lse1, delta1, True))
        e_q, e_k, e_v = (bwd_close(f"bf16 {n} {tag}", g[b:b + 1, h:h + 1], w)
                         for n, g, w in zip(("dQ", "dK", "dV"),
                                            (dq, dk, dv), want))
        print(f"check bf16 flash {tag}: O max abs err {err_o:.3e}, "
              f"{used_o:.3f} of its bound, LSE {err_l:.3e}; dQ {e_q:.3e}, dK "
              f"{e_k:.3e}, dV {e_v:.3e} (the tolerances above)")
        errs[names[0]] = max(errs[names[0]], err_o, err_l)
        errs[names[1]] = max(errs[names[1]], e_q)
        errs[names[2]] = max(errs[names[2]], e_k, e_v)
        del want
    return errs


def flash_bf16_phase(torch, card, dev):
    """Phase 14: the three bf16 flash kernels against the plain versions,
    the op's routing through autograd, their times beside the library's,
    and ``bench_attention`` at its defaults.  Returns the kernels' report
    entries, launches from the ``bench_attention`` run."""
    from analytics_zoo_torch.benchmarks.attention import bench_attention
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.ops import kernels

    t_phase = time.perf_counter()
    names = fa.KERNELS[torch.bfloat16]
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def bwd_close(name, got, want):
        atol = (BF16_BWD_ATOL_SHARE * float(want.abs().max()) +
                BF16_BWD_ATOL_FLOOR)
        return close(name, got.float(), want.float(), atol, BF16_BWD_RTOL)

    # ---- 14a. each kernel against its plain version; two launches
    errs = {name: 0.0 for name in names}
    for shape in BF16_SHAPES:
        q, k, v, do = (randn(shape) for _ in range(4))
        for causal in (False, True):
            tag = f"{shape} causal={causal}"
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err_o, used_o = o_close(f"bf16 forward {tag} O", o, o_ref)
            err_l = close(f"bf16 forward {tag} LSE", lse, lse_ref,
                          BF16_LSE_ATOL)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"bf16 forward {tag}: two launches differ")
            # what the same bound reads for the former order
            control = o_fault2_order(torch, q, k, v, causal).float()
            used_control = o_used(control, o_ref)
            del o2, lse2, o_ref, lse_ref, control
            delta = fa.flash_attention_delta(o, do)
            got = (fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
                   *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
            again = (fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
                     *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                fail(f"bf16 backward {tag}: two launches differ")
            del again
            want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
                    *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                causal))
            torch.cuda.synchronize()
            e_q, e_k, e_v = (bwd_close(f"bf16 {n} {tag}", g, w) for n, g, w
                             in zip(("dQ", "dK", "dV"), got, want))
            print(f"check bf16 flash {tag}: O max abs err {err_o:.3e}, "
                  f"{used_o:.3f} of its bound (|O| max "
                  f"{float(o.float().abs().max()):.3e}; rtol {BF16_O_RTOL}, "
                  f"atol {BF16_O_ROW_RMS} x the row's RMS; S rounded first "
                  f"reads {used_control:.3f}), LSE {err_l:.3e} "
                  f"(atol {BF16_LSE_ATOL}); dQ {e_q:.3e}, dK {e_k:.3e}, dV "
                  f"{e_v:.3e} (|dQ|,|dK|,|dV| max "
                  + ", ".join(f"{float(w.float().abs().max()):.3e}"
                              for w in want)
                  + f"; rtol {BF16_BWD_RTOL}, atol {BF16_BWD_ATOL_SHARE} x "
                  f"max + {BF16_BWD_ATOL_FLOOR}); two launches bit-identical")
            errs[names[0]] = max(errs[names[0]], err_o, err_l)
            errs[names[1]] = max(errs[names[1]], e_q)
            errs[names[2]] = max(errs[names[2]], e_k, e_v)
            del got, want, o, lse, delta
        del q, k, v, do
        # P's rounding: where key 0 leads every row, the kernel and the
        # plain version round P alike, and both controls must fail
        q, k, v = leading_key_inputs(torch, shape, gen, dev)
        for causal in (False, True):
            tag = f"{shape} causal={causal}, key 0 leading"
            o = fa.flash_attention_fwd(q, k, v, causal=causal)[0]
            o_ref = fa.flash_attention_ref(q, k, v, causal=causal)[0]
            tipped, used = o_tipped(o, o_ref)
            controls = [o_tipped(fn(torch, q, k, v, causal), o_ref)
                        for fn in (o_fault2_order, o_unrounded_p)]
            torch.cuda.synchronize()
            if not (tipped <= BF16_O_TIPPED_SHARE and used <= 1.0):
                fail(f"bf16 forward {tag}: O differs from the plain "
                     f"version's on {tipped:.4%} of its elements (at most "
                     f"{BF16_O_TIPPED_SHARE:.0%}), {used:.3f} of its "
                     "tolerance")
            if any(c_share <= BF16_O_TIPPED_SHARE and c_used <= 1.0
                   for c_share, c_used in controls):
                fail(f"bf16 forward {tag}: a control passes the check "
                     f"({controls})")
            print(f"check bf16 flash {tag}: O differs from the plain "
                  f"version's on {tipped:.4%} of its elements (at most "
                  f"{BF16_O_TIPPED_SHARE:.0%}), {used:.3f} of its "
                  f"tolerance; S rounded first on "
                  f"{controls[0][0]:.2%} ({controls[0][1]:.3f}), P "
                  f"unrounded on {controls[1][0]:.2%} ({controls[1][1]:.3f})")
            del o, o_ref
        del q, k, v
    for shape in BF16_FWD_SHAPES:
        q, k, v = (randn(shape) for _ in range(3))
        for causal in (False, True):
            tag = f"{shape} causal={causal}"
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err_o, used_o = o_close(f"bf16 forward {tag} O", o, o_ref)
            err_l = close(f"bf16 forward {tag} LSE", lse, lse_ref,
                          BF16_LSE_ATOL)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"bf16 forward {tag}: two launches differ")
            errs[names[0]] = max(errs[names[0]], err_o, err_l)
            del o2, lse2
            # key 0 leading: with one key (T = 1) O is V's row in every
            # order, so the controls cannot fail there
            ql, kl, vl = leading_key_inputs(torch, shape, gen, dev)
            o_lead = fa.flash_attention_fwd(ql, kl, vl, causal=causal)[0]
            want = fa.flash_attention_ref(ql, kl, vl, causal=causal)[0]
            tipped, used = o_tipped(o_lead, want)
            controls = [o_tipped(fn(torch, ql, kl, vl, causal), want)
                        for fn in (o_fault2_order, o_unrounded_p)]
            if not (tipped <= BF16_O_TIPPED_SHARE and used <= 1.0):
                fail(f"bf16 forward {tag}, key 0 leading: O differs from the "
                     f"plain version's on {tipped:.4%} of its elements, "
                     f"{used:.3f} of its tolerance")
            if shape[2] > 1 and any(c_share <= BF16_O_TIPPED_SHARE and
                                    c_used <= 1.0
                                    for c_share, c_used in controls):
                fail(f"bf16 forward {tag}, key 0 leading: a control passes "
                     f"the check ({controls})")
            print(f"check bf16 forward {tag}: O max abs err {err_o:.3e}, "
                  f"{used_o:.3f} of its bound, LSE {err_l:.3e}, two launches "
                  f"bit-identical; key 0 leading: O differs on "
                  f"{tipped:.4%} ({used:.3f}), S rounded first on "
                  f"{controls[0][0]:.2%}, P unrounded on "
                  f"{controls[1][0]:.2%}")
            del o, lse, o_ref, lse_ref, o_lead, want, ql, kl, vl
        del q, k, v
    torch.cuda.empty_cache()

    # ---- 14b. the op's routing, forward and backward through autograd
    f32_names = fa.KERNELS[torch.float32]
    for dtype, d, fired in ((torch.bfloat16, 64, names),
                            (torch.bfloat16, 128, names),
                            (torch.float32, 64, f32_names),
                            (torch.bfloat16, 32, ()),
                            (torch.float32, 32, ())):
        leaves = [randn((2, 4, 256, d), dtype).requires_grad_()
                  for _ in range(3)]
        kernels.reset_launch_counts()
        o = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(o.float().sum(), leaves)
        counts = kernels.launch_counts()
        expect_launches(counts, {n: 1 for n in fired},
                        f"flash_attention {dtype} head_dim {d}")
        if o.dtype != dtype or any(g_.dtype != dtype or
                                   not torch.isfinite(g_.float()).all()
                                   for g_ in grads):
            fail(f"flash_attention {dtype} head_dim {d}: output or "
                 "gradients of the wrong dtype or not finite")
        if not fired:
            with torch.no_grad():
                plain = fa.flash_attention_ref(*leaves, causal=True)[0]
            if not torch.equal(o.detach(), plain):
                fail(f"flash_attention {dtype} head_dim {d}: not the plain "
                     "result")
        print(f"routing: flash_attention {dtype} head_dim {d} causal, "
              f"forward and backward: launches "
              f"{ {n: c for n, c in counts.items() if c} or 'none' }")

    # ---- 14c. times at bench_attention's shape, and at twice its sequence
    sdpa = torch.nn.functional.scaled_dot_product_attention
    report = {}
    for shape in (BF16_BENCH, BF16_BENCH[:2] + (2 * BF16_BENCH[2],)
                  + BF16_BENCH[3:]):
        full = shape == BF16_BENCH
        q, k, v, do = (randn(shape) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.flash_attention_delta(o, do)
        if not full:
            errs_2x = check_bf16_heads(torch, fa, q, k, v, do, o, lse, delta,
                                       bwd_close)
            for name, err in errs_2x.items():
                errs[name] = max(errs[name], err)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        backend = sdpa_backend(torch, q, k, v)
        lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
        out = sdpa(qg, kg, vg, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        lib_both = time_ms(torch, lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do))
        del out
        runs = (
            (names[0], lambda: fa.flash_attention_fwd(q, k, v, causal=True),
             lambda: fa.flash_attention_ref(q, k, v, causal=True),
             (2, 4, 1), lib_fwd,
             "analytics_zoo_torch/csrc/flash_attention_fwd_bf16.cu",
             "analytics_zoo_tpu/ops/pallas_attention.py:51"),
            (names[1], lambda: fa.flash_attention_dq(q, k, v, do, lse, delta,
                                                     True),
             lambda: fa.flash_attention_dq_ref(q, k, v, do, lse, delta, True),
             (5, 5, 2), lib_bwd,
             "analytics_zoo_torch/csrc/flash_attention_bwd_bf16.cu",
             "analytics_zoo_tpu/ops/pallas_attention.py:94"),
            (names[2], lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                      True),
             lambda: fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                True),
             (8, 6, 2), lib_bwd,
             "analytics_zoo_torch/csrc/flash_attention_bwd_bf16.cu",
             "analytics_zoo_tpu/ops/pallas_attention.py:134"))
        for name, fn, plain_fn, work, lib, src, ref in runs:
            ms = time_ms(torch, fn)
            plain = time_ms(torch, plain_fn) if full else None
            passes = work[0]
            bnd, by = flash_bf16_bound(shape, True, *work)
            print(f"time {name} {shape} bf16 causal: kernel_ms {ms:.5f} "
                  f"plain_ms {'not run' if plain is None else f'{plain:.5f}'} "
                  f"library_ms {lib:.5f} bound_ms {bnd:.6f} ({by}, "
                  f"{passes} bf16 passes) {bnd / ms:.3f} of the bound "
                  f"({card})")
            if full:
                report[name] = dict(route="cuda", source=src, replaces=ref,
                                    max_abs_err=errs[name], ms=ms,
                                    plain_ms=plain, bound_ms=bnd, bound_by=by,
                                    library_ms=lib)
        both = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, *fa.flash_attention_fwd(q, k, v, causal=True), do,
            causal=True))
        print(f"library: bf16 scaled_dot_product_attention {shape} causal "
              f"({backend}): forward {lib_fwd:.5f} ms, backward {lib_bwd:.5f} "
              f"ms, forward + backward {lib_both:.5f} ms; the kernels' "
              f"forward + backward (with delta) {both:.5f} ms ({card})")
        del q, k, v, do, o, lse, delta, qg, kg, vg
        torch.cuda.empty_cache()

    # ---- 14d. the entry point: bench_attention at its defaults
    kernels.reset_launch_counts()
    result = bench_attention()
    launches = kernels.launch_counts()
    runs_ = 16 * (1 + 5) * 2        # ITERS x (untimed + repeats) x 2 lengths
    expect_launches(launches, {n: runs_ for n in names},
                    "bench_attention (bf16, causal, 4096 and 8192)")
    if not all(np.isfinite(result[key]) and result[key] > 0 for key in (
            "value", "flash_ms", "dense_ms", "flash_2x_seq_ms")):
        fail(f"bench_attention returned {result}")
    print(f"bench_attention: {json.dumps(result)} ({card})")
    print(f"bench_attention launches: {launches} (1 each an iteration, "
          f"{runs_} iterations)")
    for name in names:
        report[name]["launches"] = launches[name]
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return report


# ------------------------------------------- phase 15: model persistence
# the phase 3/4 model's training data and schedule: 64 seeded sequences,
# batch 8 (8 steps an epoch), Adam(lr=1e-4), dropout seed 0
PERSIST_ROWS, PERSIST_BATCH = 64, 8
# the fault of 15b: before the 11th step, in the second epoch, after the
# snapshot at iteration 8
FAULT_STEP = 10
# examples/chatbot/seq2seq_example.py:34-52: vocabulary 40, 8 tokens,
# 4096 dialogues, embedding 48, one LSTM of 96, bridge "pass", batch 128,
# Adam(lr=0.01)
CHAT_VOCAB, CHAT_LEN, CHAT_ROWS, CHAT_BATCH = 40, 8, 4096, 128
CHAT_STEPS_TIMED = 20


def bert_base():
    """The phase 3/4 ``TextClassifier`` at BERT-base widths, not yet
    built (phase 15d's serving-CLI builder: ``chip_smoke:bert_base``)."""
    from analytics_zoo_torch.models.textclassification import TextClassifier
    return TextClassifier(class_num=20, token_length=768,
                          sequence_length=512, encoder="transformer",
                          n_head=12, n_block=12, max_words_num=30521,
                          encoder_output_dim=256)


def chat_seq2seq():
    from analytics_zoo_torch.models.seq2seq import Seq2seq
    return Seq2seq(vocab_size=CHAT_VOCAB, embed_dim=48, hidden_sizes=(96,),
                   bridge="pass")


def chat_data():
    """The chatbot example's reversal dialogue (``_dialogue_data``)."""
    rs = np.random.RandomState(0)
    src = rs.randint(3, CHAT_VOCAB, (CHAT_ROWS, CHAT_LEN)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    dec_in = np.concatenate(
        [np.full((CHAT_ROWS, 1), GEN_START, np.int32), tgt[:, :-1]], axis=1)
    return [src, dec_in], tgt[..., None]


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    block.  The embeddings' backward (``index_add_``) sums a batch's rows
    into the table with atomics, in no fixed order on the card: ~1e-9 of a
    leaf, which the bf16 rounding of each product's operands and the
    max-pool's choice of token can amplify into a different step (phase
    15a on the H100 without this mode: the same uninterrupted run twice
    agreed but for 3.7e-9 on one leaf, while a run resumed from a
    bit-exact snapshot took another branch at its third step and moved the
    last epoch's loss by 4.6e-4).  Under this mode ``index_add_`` takes
    PyTorch's deterministic path, so a run and its replay can be held bit
    for bit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def fit_run(torch, build, x, y, epochs, batch, optim, model_dir=None):
    """A fresh model from ``build`` (names reset, weights seeded 0) trained
    through ``compile``/``fit`` for ``epochs`` (dropout seed 0), with
    ``set_checkpoint(model_dir)`` when one is given; (model, history)."""
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    Layer.reset_name_counters()
    model = build()
    net = getattr(model, "model", model)
    net.init(torch.Generator().manual_seed(0))
    model.compile(optim(), "sparse_categorical_crossentropy_with_logits")
    if model_dir is not None:
        net.set_checkpoint(model_dir)
    return model, model.fit(x, y, batch_size=batch, nb_epoch=epochs, rng=0)


def leaf_diffs(a, b):
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    return [float((p - q).abs().max()) for p, q in zip(
        tree_leaves(a.get_variables()["params"]),
        tree_leaves(b.get_variables()["params"]))]


def hold_resumed(what, losses, model, whole, control, card):
    """15a's standard: ``model`` and its epoch ``losses`` against the
    uninterrupted run ``whole``; bit-identical if ``control`` (the same
    uninterrupted run again) is bit-identical to ``whole``, else every
    leaf within twice the largest leaf difference of the control (and the
    losses within twice the control's)."""
    w_losses, c_losses = ([h["loss"] for h in r[1]] for r in (whole,
                                                              control))
    if len(losses) != len(w_losses):
        fail(f"{what}: {len(losses)} epoch losses, want {len(w_losses)}")
    d_ctl = leaf_diffs(whole[0], control[0])
    d_got = leaf_diffs(model, whole[0])
    loss_ctl = max(abs(a - b) for a, b in zip(w_losses, c_losses))
    loss_got = max(abs(a - b) for a, b in zip(losses, w_losses))
    if max(d_ctl) == 0.0 and loss_ctl == 0.0:
        rule = "bit-identical (the control is)"
        ok = max(d_got) == 0.0 and loss_got == 0.0
    else:
        rule = (f"within twice the control's largest leaf difference "
                f"{max(d_ctl):.3e} and loss difference {loss_ctl:.3e}")
        ok = max(d_got) <= 2 * max(d_ctl) and loss_got <= 2 * loss_ctl
    print(f"{what}: {len(d_got)} leaves, max abs diff against the "
          f"uninterrupted run {max(d_got):.3e} ({sum(d > 0 for d in d_got)} "
          f"leaves differ), epoch losses {losses} vs {w_losses} (max diff "
          f"{loss_got:.3e}); control: {sum(d > 0 for d in d_ctl)} leaves "
          f"differ, max {max(d_ctl):.3e}, losses max diff {loss_ctl:.3e}; "
          f"standard: {rule} ({card})")
    if not ok:
        fail(f"{what}: not {rule}")


def snapshot_lines(what, card) -> None:
    """Print the checkpoint spans the tracer holds (bytes, seconds, MB/s)
    and clear it."""
    from analytics_zoo_torch.observability import get_tracer
    tracer = get_tracer()
    spans = [e for e in tracer.events()
             if e["name"] in ("checkpoint_save", "checkpoint_restore")]
    for e in spans:
        n, sec = e["args"]["bytes"], e["dur"] * 1e-6
        print(f"{what} {e['name']} at iteration {e['args']['iteration']}: "
              f"{n} bytes in {sec:.4f} s, {n / sec / 1e6:.1f} MB/s ({card})")
    tracer.clear()


def counter(name):
    from analytics_zoo_torch.observability import get_registry
    return get_registry().counter(name).value


def profile_seq2seq_train() -> None:
    """``--profile-seq2seq-train``: in a process of its own, one
    ``torch.profiler`` session over one ``train_step_at`` of the chatbot
    ``Seq2seq`` (batch 128 x 8 tokens, Adam), after two untimed steps.
    Prints one JSON line as ``--profile-recurrent`` does."""
    import torch

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    init_zoo_context(device="cuda:0")
    m = chat_seq2seq()
    m.init(torch.Generator().manual_seed(0))
    tr = DistributedTrainer(m, objectives.get(
        "sparse_categorical_crossentropy_with_logits"),
        optim_method=Adam(lr=0.01))
    params = tr.place_params(m.get_variables()["params"])
    opt_state, state = tr.init_opt_state(params), {}
    x, y = chat_data()
    batch = tr.put_batch(([a[:CHAT_BATCH] for a in x], y[:CHAT_BATCH]))
    step = [0]

    def one():
        nonlocal params, opt_state, state
        params, opt_state, state, _ = tr.train_step_at(
            params, opt_state, state, batch, 0, step[0])
        step[0] += 1
    one()
    one()
    out, unplaced = profile_ranges(torch, {"seq2seq_train_step": one},
                                   kernel_kind)
    for o in out.values():
        o["top"] = o.pop("by_kind")[:6]
    print(json.dumps({"profile": out, "unplaced": unplaced}))


def persistence_phase(torch, card, dev, rec_profile):
    """Phase 15: model persistence on the main path.  15a a BERT-base
    ``fit`` with ``set_checkpoint`` resumed by a fresh model, held to the
    uninterrupted run and its control; 15b one injected transient fault,
    one restore; 15c ``save_model`` → ``InferenceModel.load_zoo_file``
    against ``load_zoo`` (float32 and weight-only int8); 15d the serving
    CLI's ``weights:`` behind Cluster Serving; 15e the chatbot
    ``Seq2seq`` resumed likewise, its step ms and a profiled step beside
    phase 10's inference profile; 15f the snapshots removed.  Returns the
    launches of 15a's resumed training (16 + 8 steps)."""
    import shutil
    import tempfile

    from analytics_zoo_torch.observability import get_tracer
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.resilience.chaos import (
        ChaosPlan, FaultSpec, clear_chaos, install_chaos)
    from analytics_zoo_torch.serving import cli

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_persistence_")
    get_tracer().clear()
    try:
        # ---- 15a. resume at BERT-base width
        rs = np.random.RandomState(15)
        x = rs.randint(0, 30522, size=(PERSIST_ROWS, 512)).astype(np.int64)
        y = rs.randint(0, 20, size=(PERSIST_ROWS,)).astype(np.int64)

        def bert_fit(epochs, model_dir=None):
            with deterministic(torch):
                return fit_run(torch, bert_base, x, y, epochs,
                               PERSIST_BATCH, lambda: Adam(lr=1e-4),
                               model_dir)
        steps = PERSIST_ROWS // PERSIST_BATCH
        ckpt_a = os.path.join(root, "bert")
        kernels.reset_launch_counts()
        _, first = bert_fit(2, ckpt_a)
        restores = counter("checkpoint_restore_total")
        resumed, rest = bert_fit(3, ckpt_a)
        launches = kernels.launch_counts()
        if counter("checkpoint_restore_total") != restores + 1 or \
                [h["epoch"] for h in rest] != [3]:
            fail(f"resume: restores {counter('checkpoint_restore_total')}"
                 f" (was {restores}), history {rest}")
        want = {name: 0 for name in kernels.SIGNATURES}
        n = 3 * steps
        want.update(flash_attention_fwd=12 * n, flash_attention_dq=12 * n,
                    flash_attention_dkv=12 * n, bias_gelu=12 * n,
                    layernorm_act=n, fused_adam=n)
        if launches != want:
            fail(f"15a launch counts {launches} != {want}")
        print(f"15a fit 2 epochs with set_checkpoint, then a fresh model's "
              f"fit to 3 epochs resumed at epoch 2, iteration {2 * steps}: "
              f"launches {launches} over {n} steps")
        snapshot_lines("15a", card)
        whole = bert_fit(3)
        control = bert_fit(3)
        hold_resumed("15a resumed BERT-base",
                     [h["loss"] for h in first + rest], resumed, whole,
                     control, card)

        # ---- 15b. one transient fault, one restore
        restores = counter("checkpoint_restore_total")
        retries = counter("train_retry_total")
        install_chaos(ChaosPlan([FaultSpec("trainer.dispatch",
                                           at_step=FAULT_STEP)]))
        try:
            faulted, fh = bert_fit(3, os.path.join(root, "fault"))
        finally:
            clear_chaos()
        restores = counter("checkpoint_restore_total") - restores
        retries = counter("train_retry_total") - retries
        if restores != 1 or retries != 1:
            fail(f"15b: {restores} restores, {retries} retries, want 1 "
                 "each")
        print(f"15b TransientFault before step {FAULT_STEP}: 1 retry, 1 "
              f"restore (the snapshot at iteration {steps}), "
              f"{len(fh)} epochs")
        snapshot_lines("15b", card)
        hold_resumed("15b faulted BERT-base", [h["loss"] for h in fh],
                     faulted, whole, control, card)
        del faulted, control
        torch.cuda.empty_cache()

        # ---- 15c. save_model -> load_zoo_file against load_zoo
        path = os.path.join(root, "bert_base.model")
        t0 = time.perf_counter()
        resumed.save_model(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        Layer.reset_name_counters()
        fresh = bert_base()
        t0 = time.perf_counter()
        im_file = InferenceModel().load_zoo_file(fresh, path)
        load_s = time.perf_counter() - t0
        print(f"15c save_model: {size} bytes in {save_s:.4f} s "
              f"({size / save_s / 1e6:.1f} MB/s); a fresh model's "
              f"load_zoo_file (build, weights drawn, file read and placed) "
              f"{load_s:.4f} s ({card})")
        reqs = [np.random.RandomState(16 + i).randint(
            0, 30522, size=(8, 512)).astype(np.int64) for i in range(4)]
        per_request = {name: 0 for name in kernels.SIGNATURES}
        per_request.update(flash_attention_fwd=12, bias_gelu=12,
                           layernorm_act=1)
        for quantize in (False, True):
            im_f = im_file if not quantize else InferenceModel(
                ).load_zoo_file(fresh, path, quantize=True)
            im_m = InferenceModel().load_zoo(resumed, quantize=quantize)
            kernels.reset_launch_counts()
            outs = [im_f.predict(r, batch_size=8) for r in reqs]
            counts = kernels.launch_counts()
            if counts != {k: 4 * v for k, v in per_request.items()}:
                fail(f"15c load_zoo_file quantize={quantize}: launches "
                     f"{counts} over 4 requests")
            ref = [im_m.predict(r, batch_size=8) for r in reqs]
            for a, b in zip(outs, ref):
                if a.shape != (8, 20) or not np.isfinite(a).all() or \
                        not np.array_equal(a, b):
                    fail(f"15c quantize={quantize}: load_zoo_file logits "
                         f"differ from load_zoo's by "
                         f"{float(np.abs(a - b).max())}")
            print(f"15c load_zoo_file(quantize={quantize}) vs load_zoo("
                  f"quantize={quantize}) of the model in memory: 4 requests "
                  f"of 8 x 512, logits bit-identical; launches {counts}")
            del im_m

        # ---- 15d. the serving CLI's weights:
        Layer.reset_name_counters()
        t0 = time.perf_counter()
        served_model = cli._build_model("chip_smoke:bert_base",
                                        weights=path)
        im_cli = InferenceModel().load_zoo(served_model)
        build_s = time.perf_counter() - t0
        run = serve_front_end(torch, im_cli, fail, n_singles=0,
                              queued_first=True, n_stream=8, buckets=(8,))
        ref = im_file.predict(run["inputs"], batch_size=8)
        want_top5 = np.argsort(-ref, axis=-1)[:, :5].tolist()
        got_top5 = [[c for c, _ in res] for res in run["results"]]
        if got_top5 != want_top5:
            fail(f"15d: CLI-served top-5 {got_top5} != 15c's {want_top5}")
        print(f"15d cli._build_model('chip_smoke:bert_base', weights=...) "
              f"and load_zoo in {build_s:.3f} s; 8 records through "
              f"ClusterServing (BrokerServer, bucket 8) in "
              f"{run['batches']} batch(es): top-5 classes equal 15c's; "
              f"launches {run['launches']} ({card})")
        del im_file, im_cli, served_model, fresh, resumed, whole
        torch.cuda.empty_cache()

        # ---- 15e. the chatbot Seq2seq: resume, step ms, a profiled step
        cx, cy = chat_data()

        def chat_fit(epochs, model_dir=None):
            with deterministic(torch):
                return fit_run(torch, chat_seq2seq, cx, cy, epochs,
                               CHAT_BATCH, lambda: Adam(lr=0.01), model_dir)
        ckpt_e = os.path.join(root, "seq2seq")
        t0 = time.perf_counter()
        _, cfirst = chat_fit(2, ckpt_e)
        fit_s = time.perf_counter() - t0
        cresumed, crest = chat_fit(3, ckpt_e)
        snapshot_lines("15e", card)
        cwhole = chat_fit(3)
        ccontrol = chat_fit(3)
        hold_resumed("15e resumed Seq2seq",
                     [h["loss"] for h in cfirst + crest], cresumed, cwhole,
                     ccontrol, card)
        print(f"15e Seq2seq fit: 2 epochs of {CHAT_ROWS // CHAT_BATCH} "
              f"steps in {fit_s:.3f} s (first, warm-up included); epoch "
              f"losses {[round(h['loss'], 5) for h in cfirst + crest]}")
        tr = DistributedTrainer(cresumed, objectives.get(
            "sparse_categorical_crossentropy_with_logits"),
            optim_method=Adam(lr=0.01))
        params = tr.place_params(cresumed.get_variables()["params"])
        opt_state, state = tr.init_opt_state(params), {}
        batch = tr.put_batch(([a[:CHAT_BATCH] for a in cx], cy[:CHAT_BATCH]))
        step_ms = []
        for i in range(3 + CHAT_STEPS_TIMED):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            params, opt_state, state, loss = tr.train_step_at(
                params, opt_state, state, batch, 0, i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - s0) * 1e3)
        step_ms = step_ms[3:]
        if not np.isfinite(float(loss)):
            fail(f"15e step loss {float(loss)}")
        print(f"15e Seq2seq train_step_at (batch {CHAT_BATCH} x "
              f"{CHAT_LEN} tokens, Adam): median "
              f"{statistics.median(step_ms):.3f} ms, min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f} over "
              f"{[round(t, 3) for t in step_ms]} ({card})")
        del cresumed, cwhole, ccontrol, tr, params, opt_state
        child = subprocess.run(
            [sys.executable, __file__, "--profile-seq2seq-train"],
            capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            fail(f"--profile-seq2seq-train exited {child.returncode}: "
                 f"{child.stderr[-2000:]}")
        prof = json.loads(child.stdout.strip().splitlines()[-1])
        if prof["unplaced"]:
            fail(f"profile: {len(prof['unplaced'])} device events outside "
                 f"the range: {prof['unplaced'][:8]}")
        o = prof["profile"]["seq2seq_train_step"]
        print(f"profile seq2seq_train_step (torch.profiler): "
              f"{o['launches']} device kernels, {o['copies']} copies, "
              f"device busy {o['busy_ms']:.4f} ms of {o['wall_ms']:.4f} ms "
              f"wall, idle share {o['idle_share']:.4f}; by kind (count, ms) "
              f"{o['top']} ({card})")
        print("15e beside phase 10's inference profile: " + "; ".join(
            f"{k} idle share {v['idle_share']:.4f}, {v['launches']} "
            f"kernels, {v['wall_ms']:.3f} ms wall"
            for k, v in rec_profile.items()))
    finally:
        # ---- 15f. the snapshots (BERT-base ~1.3 GB each) removed
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        fail(f"15f: {root} was not removed")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------ phase 16: the Keras transformer models
# GPT-1 (Radford et al. 2018, "Improving Language Understanding by
# Generative Pre-Training", §4.1): 12 decoder blocks, 768 wide, 12 heads of
# 64, FFN 3072, a 512-token context, a BPE vocabulary of 40478.  The
# reference's default embedding shares one table between the tokens and
# 512 position slots: vocab 40990, position ids arange(40478, 40990).
GPT1_TOKENS, GPT1_SEQ = 40478, 512
GPT1 = dict(vocab=GPT1_TOKENS + GPT1_SEQ, seq_len=GPT1_SEQ, n_block=12,
            n_head=12, hidden_size=768)
GPT1_ROWS, GPT1_BATCH = 64, 8
# google-research/bert's BERT-Base, Uncased bert_config.json (vocabulary
# 30522, hidden 768, 12 layers, 12 heads, intermediate 3072, 512
# positions, 2 token types, LayerNorm eps 1e-12), its gelu taken as
# BERT's default here ("gelu", the tanh form the bias→GeLU kernel
# computes; a checkpoint's bert_config maps to "gelu_erf", no kernel)
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 intermediate_size=3072, max_position_len=512,
                 type_vocab_size=2, hidden_act="gelu", ln_eps=1e-12)
# run_classifier.py: max_seq_length 128, train_batch_size 32, 2 classes;
# run_squad.py: max_seq_length 384; CoNLL-2003's 9 BIO tags for BERTNER
CLS_SEQ, CLS_BATCH, CLS_STEPS = 128, 32, 8
SQUAD_SEQ, SQUAD_ROWS = 384, 12
NER_TAGS = 9
# TransformerLayer's default seq_len: the port takes the flash kernel
# there, the reference dense attention (77 % 256 != 0)
ROUTE_SEQ = 77
PHASE16_LOSS = "sparse_categorical_crossentropy_with_logits"


def gpt1_model(torch, seed=0):
    """``TransformerLayer.init_with_default_embedding`` at GPT-1's width
    with ``TimeDistributed(Dense(40478))`` over its sequence output, the
    weights drawn from ``seed``."""
    from analytics_zoo_torch.pipeline.api.keras import Model
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        Dense, TimeDistributed, TransformerLayer)
    Layer.reset_name_counters()
    enc = TransformerLayer.init_with_default_embedding(**GPT1).build()
    logits = TimeDistributed(Dense(GPT1_TOKENS))(enc.outputs[0])
    model = Model(enc.inputs, logits)
    model.init(torch.Generator().manual_seed(seed))
    return model


def gpt1_data(rows, seed):
    """Seeded token rows with their offset position ids, and next-token
    targets."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, GPT1_TOKENS, (rows, GPT1_SEQ + 1)).astype(np.int64)
    pos = np.broadcast_to(np.arange(GPT1_TOKENS, GPT1_TOKENS + GPT1_SEQ,
                                    dtype=np.int64), (rows, GPT1_SEQ))
    return [ids[:, :-1], pos.copy()], ids[:, 1:].copy()


def bert_features(rows, seq, seed):
    """Seeded sentence pairs as run_classifier.py feeds them: [CLS] A [SEP]
    B [SEP], token types 0 then 1, zero padding past a random length."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, 30522, (rows, seq)).astype(np.int64)
    types = np.zeros((rows, seq), np.int64)
    mask = np.zeros((rows, seq), np.int64)
    for r, n in enumerate(rs.randint(seq // 4, seq + 1, rows)):
        cut = int(rs.randint(2, n - 1))
        ids[r, 0], ids[r, cut], ids[r, n - 1] = 101, 102, 102
        types[r, cut + 1:n] = 1
        mask[r, :n] = 1
        ids[r, n:] = 0
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask}


def gpt1_serving(torch, card, dev, model):
    """16a: 4 requests of 8 x 512 through ``InferenceModel``; returns the
    launches of the 4."""
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    im = InferenceModel().load_zoo(model)
    x, _ = gpt1_data(5 * GPT1_BATCH, 16)
    reqs = [[a[i * GPT1_BATCH:(i + 1) * GPT1_BATCH] for a in x]
            for i in range(5)]
    im.predict(reqs[4], batch_size=GPT1_BATCH)        # warm-up, not counted
    kernels.reset_launch_counts()
    lat, first = [], None
    for req in reqs[:4]:
        s = time.perf_counter()
        out = im.predict(req, batch_size=GPT1_BATCH)  # host numpy
        lat.append((time.perf_counter() - s) * 1e3)
        if out.shape != (GPT1_BATCH, GPT1_SEQ, GPT1_TOKENS) or \
                not np.isfinite(out).all():
            fail(f"GPT-1 logits shape {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
        first = out if first is None else first
    launches = kernels.launch_counts()
    expect_launches(launches, {"flash_attention_fwd": 48, "bias_gelu": 48},
                    "GPT-1 serving (4 requests)")
    plain = plain_route(lambda: im.predict(reqs[0], batch_size=GPT1_BATCH))
    if kernels.launch_counts() != launches:
        fail("GPT-1 under ops.fused=torch launched a kernel")
    diff = float(np.abs(plain - first).max())
    print(f"16a GPT-1 served: launches over 4 requests {launches}; logits "
          f"vs ops.fused=torch max abs diff {diff:.3e} (tolerance "
          f"{MODEL_ATOL}), |logits| max {float(np.abs(first).max()):.3e}")
    if not diff <= MODEL_ATOL:
        fail(f"GPT-1 kernel and plain logits differ by {diff}")
    med = statistics.median(lat)
    print(f"16a GPT-1 request latency ({GPT1_BATCH} x {GPT1_SEQ} in, "
          f"{first.nbytes} bytes of "
          f"float32 logits out): median {med:.3f} ms, min {min(lat):.3f}, "
          f"max {max(lat):.3f} over {lat}; {GPT1_BATCH * 1e3 / med:.1f} "
          f"sequences/s ({card})")
    # the same forward with the logits left on the card: what of a
    # request is the device's, and what the copy of the logits to the host
    variables = model.get_variables()
    xd = [torch.as_tensor(a, device=dev) for a in reqs[0]]
    fwd = []
    for _ in range(5):
        torch.cuda.synchronize()
        s = time.perf_counter()
        with torch.no_grad():
            model.apply(variables["params"], xd, state=variables["state"],
                        training=False)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - s) * 1e3)
    fwd = fwd[1:]
    print(f"16a GPT-1 forward alone, logits left on the card: median "
          f"{statistics.median(fwd):.3f} ms, min {min(fwd):.3f}, max "
          f"{max(fwd):.3f} over {fwd} ({card})")
    return launches


def gpt1_training(torch, card, dev, model):
    """16b: ``fit`` for 8 steps, one step's gradients against the plain
    versions under float32 products, step ms in turns, peak memory;
    returns the fit's launches."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    x, y = gpt1_data(GPT1_ROWS, 17)
    model.compile(Adam(lr=1e-4), PHASE16_LOSS)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=GPT1_BATCH, nb_epoch=1, rng=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.launch_counts()
    steps = GPT1_ROWS // GPT1_BATCH
    expect_launches(launches, {
        "flash_attention_fwd": 12 * steps, "flash_attention_dq": 12 * steps,
        "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
        "fused_adam": steps}, "GPT-1 fit")
    loss = history[0]["loss"]
    if len(history) != 1 or not np.isfinite(loss):
        fail(f"GPT-1 fit history {history}")
    n_leaves = len(tree_leaves(model.get_variables()["params"]))
    print(f"16b GPT-1 fit: {steps} steps of {GPT1_BATCH} x {GPT1_SEQ} in "
          f"{fit_s:.3f} s (warm-up included), epoch loss {loss:.5f} "
          f"(ln {GPT1_TOKENS} = {np.log(GPT1_TOKENS):.5f}); launches "
          f"{launches} ({n_leaves} leaves); peak device memory {peak} "
          f"bytes ({card})")

    loss_fn = objectives.get(PHASE16_LOSS)
    batch_np = ([a[:GPT1_BATCH] for a in x], y[:GPT1_BATCH])
    tr = DistributedTrainer(model, loss_fn, optim_method=Adam(lr=1e-4))
    params = tr.place_params(model.get_variables()["params"])
    batch = tr.put_batch(batch_np)
    dtypes.set_policy(compute_dtype="float32")
    grads = {}
    for mode in ("auto", "torch"):
        get_config().set("ops.fused", mode)
        kernels.reset_launch_counts()
        loss_m, g, _ = tr.loss_and_grads(params, {}, batch,
                                         step_generator(11, 0, dev))
        grads[mode] = (float(loss_m), tree_leaves(g))
        expect_launches(kernels.launch_counts(), {} if mode == "torch" else {
            "flash_attention_fwd": 12, "flash_attention_dq": 12,
            "flash_attention_dkv": 12, "bias_gelu": 12},
            f"GPT-1 gradients under ops.fused={mode}")
    get_config().set("ops.fused", "auto")
    dtypes.restore_policy(None)
    errs = [rel_l2(a, b) for a, b in zip(grads["auto"][1],
                                         grads["torch"][1])]
    worst = max(errs)
    print(f"16b GPT-1 gradients, kernels vs plain versions, float32 "
          f"products: {len(errs)} leaves, relative L2 max {worst:.3e} median "
          f"{statistics.median(errs):.3e} (tolerance {GRAD_RTOL_F32}); loss "
          f"{grads['auto'][0]:.6f} vs {grads['torch'][0]:.6f}")
    if not worst <= GRAD_RTOL_F32:
        fail(f"GPT-1 kernel and plain gradients differ: {worst}")
    del params, grads, g

    def timed(mode, n):
        get_config().set("ops.fused", mode)
        t = DistributedTrainer(model, loss_fn, optim_method=Adam(lr=1e-4))
        p = t.place_params(model.get_variables()["params"])
        o = t.init_opt_state(p)
        out = []
        for i in range(n + 1):                 # the first is a warm-up
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            p, o, _, step_loss = t.train_step(p, o, {}, batch,
                                              step_generator(0, i, dev))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - s0) * 1e3)
        if not np.isfinite(float(step_loss)):
            fail(f"GPT-1 step loss under ops.fused={mode}")
        return out[1:]

    step_ms = {"torch": [], "auto": []}
    for mode in ("torch", "auto", "auto", "torch"):
        step_ms[mode] += timed(mode, 4)
    get_config().set("ops.fused", "auto")
    for mode in ("auto", "torch"):
        v = step_ms[mode]
        med = statistics.median(v)
        print(f"16b GPT-1 training step ops.fused={mode}: median {med:.3f} "
              f"ms, min {min(v):.3f}, max {max(v):.3f} over {v}; "
              f"{GPT1_BATCH * 1e3 / med:.1f} sequences/s, Adam ({card})")
    return launches


def causal_flash_times(torch, card, dev):
    """16b: the three float32 flash kernels at GPT-1's shape, causal,
    checked against their plain versions, then each timed beside its plain
    version, its bound (T^2/2 pairs) and ``scaled_dot_product_attention``
    in float32 causal."""
    from analytics_zoo_torch.ops import flash_attention as fa
    b, h, t, d = GPT1_BATCH, 12, GPT1_SEQ, 64
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = (torch.randn((b, h, t, d), generator=g, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=True)
    delta = fa.flash_attention_delta(o, do)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, True)
    dq_ref = fa.flash_attention_dq_ref(q, k, v, do, lse, delta, True)
    dk_ref, dv_ref = fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                True)
    torch.cuda.synchronize()
    errs = {"flash_attention_fwd": max(
                close("causal O", o, o_ref, FWD_ATOL, FWD_RTOL),
                close("causal LSE", lse, lse_ref, FWD_LSE_ATOL)),
            "flash_attention_dq": close("causal dQ", dq, dq_ref, BWD_ATOL,
                                        BWD_RTOL),
            "flash_attention_dkv": max(
                close("causal dK", dk, dk_ref, BWD_ATOL, BWD_RTOL),
                close("causal dV", dv, dv_ref, BWD_ATOL, BWD_RTOL))}
    del o_ref, lse_ref, dq_ref, dk_ref, dv_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
    out = sdpa(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del qg, kg, vg, out
    pairs = b * h * t * t / 2          # the causal half of the scores
    n_el = b * h * t * d
    times = {}
    for name, fn, plain_fn, tensors, flops, lib in (
            ("flash_attention_fwd",
             lambda: fa.flash_attention_fwd(q, k, v, causal=True),
             lambda: fa.flash_attention_ref(q, k, v, causal=True),
             4, 4, lib_fwd),
            ("flash_attention_dq",
             lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, True),
             lambda: fa.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                               True),
             5, 6, lib_bwd),
            ("flash_attention_dkv",
             lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, True),
             lambda: fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                True),
             6, 8, lib_bwd)):
        ms = time_ms(torch, fn)
        plain = time_ms(torch, plain_fn)
        moved = (tensors * n_el + 2 * b * h * t) * 4
        bnd, by = flash_bound_ms(moved, flops * pairs * d)
        times[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=lib, max_abs_err=errs[name])
        print(f"16b time {name} {(b, h, t, d)} f32 causal: kernel_ms "
              f"{ms:.5f} plain_ms {plain:.5f} bound_ms {bnd:.6f} ({by}, "
              f"3xTF32, T^2/2 pairs) library_ms {lib:.5f} "
              f"(scaled_dot_product_attention f32 causal, "
              f"{'forward' if name.endswith('fwd') else 'backward: dQ, dK, dV together'}); "
              f"max abs err {errs[name]:.3e} ({card})")
    return times


def hf_bert_state(torch, dev, seed):
    """A BERT-base state_dict under HF's names, drawn on the card."""
    from analytics_zoo_torch.tfpark.text import bert_checkpoint as bc
    H, inter = BERT_BASE["hidden_size"], BERT_BASE["intermediate_size"]
    shapes = {"embeddings.word_embeddings.weight": (BERT_BASE["vocab"], H),
              "embeddings.token_type_embeddings.weight": (2, H),
              "embeddings.position_embeddings.weight": (512, H),
              "pooler.dense.weight": (H, H)}
    names = list(bc._G2HF.values()) + [
        f"encoder.layer.{i}.{tail}" for i in range(BERT_BASE["n_block"])
        for tail in bc._BLOCK_G2HF.values()]
    g = torch.Generator(device=dev).manual_seed(seed)

    def shape(name):
        if name in shapes:
            return shapes[name]
        if name.endswith("intermediate.dense.weight"):
            return (inter, H)
        if name.endswith("intermediate.dense.bias"):
            return (inter,)
        if name.endswith("output.dense.weight") and "attention" not in name:
            return (H, inter)
        return (H, H) if name.endswith("weight") and "LayerNorm" not in name \
            else (H,)
    return {n: torch.randn(shape(n), generator=g, device=dev) * 0.02
            for n in names}


def check_loaded_bert(torch, model, sd) -> int:
    """Every encoder leaf of ``model`` against its source in ``sd``, bit
    for bit (kernels transposed, Q/K/V concatenated); returns the count."""
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        Dense, Embedding, LayerNorm, MultiHeadSelfAttention,
        PositionwiseFeedForward)
    p = model.get_variables()["params"]

    def named(cls):
        return [l.name for l in model.layers if type(l) is cls]
    emb, ln, att = named(Embedding), named(LayerNorm), \
        named(MultiHeadSelfAttention)
    ffn, dense = named(PositionwiseFeedForward), named(Dense)
    tr = lambda name: sd[name].t()                         # noqa: E731
    want = {(emb[0], "embeddings"): sd["embeddings.word_embeddings.weight"],
            (emb[1], "embeddings"):
                sd["embeddings.token_type_embeddings.weight"],
            (emb[2], "embeddings"): sd[
                "embeddings.position_embeddings.weight"][
                    :BERT_BASE["max_position_len"]],
            (ln[0], "gamma"): sd["embeddings.LayerNorm.weight"],
            (ln[0], "beta"): sd["embeddings.LayerNorm.bias"],
            (dense[0], "kernel"): tr("pooler.dense.weight"),
            (dense[0], "bias"): sd["pooler.dense.bias"]}
    for i in range(BERT_BASE["n_block"]):
        e = f"encoder.layer.{i}."
        qkv = ("query", "key", "value")
        want.update({
            (att[i], "qkv_kernel"): torch.cat(
                [tr(e + f"attention.self.{w}.weight") for w in qkv], 1),
            (att[i], "qkv_bias"): torch.cat(
                [sd[e + f"attention.self.{w}.bias"] for w in qkv]),
            (att[i], "out_kernel"): tr(e + "attention.output.dense.weight"),
            (att[i], "out_bias"): sd[e + "attention.output.dense.bias"],
            (ln[2 * i + 1], "gamma"):
                sd[e + "attention.output.LayerNorm.weight"],
            (ln[2 * i + 1], "beta"):
                sd[e + "attention.output.LayerNorm.bias"],
            (ffn[i], "up_kernel"): tr(e + "intermediate.dense.weight"),
            (ffn[i], "up_bias"): sd[e + "intermediate.dense.bias"],
            (ffn[i], "down_kernel"): tr(e + "output.dense.weight"),
            (ffn[i], "down_bias"): sd[e + "output.dense.bias"],
            (ln[2 * i + 2], "gamma"): sd[e + "output.LayerNorm.weight"],
            (ln[2 * i + 2], "beta"): sd[e + "output.LayerNorm.bias"]})
    for (layer, key), w in want.items():
        if not torch.equal(p[layer][key], w):
            fail(f"loaded checkpoint: {layer}/{key} differs from its source")
    return len(want)


def bert_finetune(torch, card, dev):
    """16c: ``BERTClassifier`` fine-tuned for 8 steps under
    ``AdamWeightDecay``, evaluated and served; ``BERTSQuAD.predict_spans``
    and ``BERTNER.predict``.  Returns the fine-tuning's launches."""
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import (
        AdamWeightDecay)
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.tfpark.text import (
        BERTClassifier, BERTNER, BERTSQuAD)

    def adamw():
        return AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=CLS_STEPS)

    Layer.reset_name_counters()
    t0 = time.perf_counter()
    clf = BERTClassifier(num_classes=2, seq_len=CLS_SEQ, **BERT_BASE)
    before = [a.clone() for a in
              tree_leaves(clf.model.get_variables()["params"])]
    build_s = time.perf_counter() - t0
    rows = CLS_BATCH * CLS_STEPS
    feats = bert_features(rows, CLS_SEQ, 18)
    labels = np.random.RandomState(18).randint(0, 2, rows)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clf.train(feats, labels, optim_method=adamw(), batch_size=CLS_BATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"bias_gelu": 12 * CLS_STEPS},
                    "BERT-base fine-tuning (the mask takes dense attention, "
                    "AdamWeightDecay its own chain)")
    loss = clf.history[0]["loss"]
    after = tree_leaves(clf.model.get_variables()["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    if not np.isfinite(loss) or moved != len(after):
        fail(f"BERT fine-tuning: loss {loss}, {moved} of {len(after)} "
             "leaves moved")
    del before
    print(f"16c BERTClassifier (BERT-base, {len(after)} leaves, built in "
          f"{build_s:.1f} s) train: {CLS_STEPS} steps of {CLS_BATCH} x "
          f"{CLS_SEQ} in {fit_s:.3f} s (warm-up included), loss "
          f"{loss:.5f}, all {moved} leaves moved; launches {launches}")

    tr = DistributedTrainer(clf.model, objectives.get(PHASE16_LOSS),
                            optim_method=adamw())
    if tr.fused_optimizer_active:
        fail("the fused update took AdamWeightDecay")
    params = tr.place_params(clf.model.get_variables()["params"])
    opt_state = tr.init_opt_state(params)
    batch = tr.put_batch((clf._inputs({k: a[:CLS_BATCH] for k, a in
                                       feats.items()}, CLS_SEQ),
                          labels[:CLS_BATCH]))
    step_ms = []
    for i in range(7):                          # the first is a warm-up
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        params, opt_state, _, _ = tr.train_step(
            params, opt_state, {}, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
    step_ms = step_ms[1:]
    print(f"16c BERT-base fine-tuning step (AdamWeightDecay, unfused, "
          f"{CLS_BATCH} x {CLS_SEQ}): median {statistics.median(step_ms):.3f}"
          f" ms, min {min(step_ms):.3f}, max {max(step_ms):.3f} over "
          f"{step_ms} ({card})")
    del tr, params, opt_state

    scores = clf.evaluate(feats, labels, batch_size=CLS_BATCH)
    s0 = time.perf_counter()
    probs = clf.predict(feats, batch_size=CLS_BATCH)
    pred_ms = (time.perf_counter() - s0) * 1e3
    if set(scores) != {"loss"} or not np.isfinite(scores["loss"]) or \
            probs.shape != (rows, 2) or not np.isfinite(probs).all():
        fail(f"BERTClassifier evaluate {scores}, predict {probs.shape}")
    print(f"16c BERTClassifier evaluate {scores}; predict of {rows} x "
          f"{CLS_SEQ} {pred_ms:.3f} ms ({card})")
    del clf

    Layer.reset_name_counters()
    squad = BERTSQuAD(seq_len=SQUAD_SEQ, **BERT_BASE)
    sfeats = bert_features(SQUAD_ROWS, SQUAD_SEQ, 19)
    squad.predict_spans(sfeats, batch_size=SQUAD_ROWS)          # warm-up
    s0 = time.perf_counter()
    start, end = squad.predict_spans(sfeats, batch_size=SQUAD_ROWS)
    squad_ms = (time.perf_counter() - s0) * 1e3
    if start.shape != end.shape or start.shape != (SQUAD_ROWS, SQUAD_SEQ) \
            or not (np.isfinite(start).all() and np.isfinite(end).all()):
        fail(f"BERTSQuAD spans {start.shape} {end.shape}")
    del squad
    Layer.reset_name_counters()
    ner = BERTNER(num_entities=NER_TAGS, seq_len=CLS_SEQ, **BERT_BASE)
    ner.predict(feats, batch_size=CLS_BATCH)                    # warm-up
    s0 = time.perf_counter()
    tags = ner.predict(feats, batch_size=CLS_BATCH)
    ner_ms = (time.perf_counter() - s0) * 1e3
    if tags.shape != (rows, CLS_SEQ, NER_TAGS) or \
            not np.isfinite(tags).all():
        fail(f"BERTNER predict {tags.shape}")
    print(f"16c BERTSQuAD.predict_spans {SQUAD_ROWS} x {SQUAD_SEQ}: start "
          f"{start.shape}, end {end.shape}, {squad_ms:.3f} ms a call; "
          f"BERTNER.predict {rows} x {CLS_SEQ}: {tags.shape}, {ner_ms:.3f} "
          f"ms a call ({card})")
    return launches


def checkpoint_and_route(torch, card, dev):
    """16d: ``BERTClassifier(bert_checkpoint=)`` from an HF-named
    state_dict drawn on the card, every encoder leaf held to its source
    and a second load's predictions; then ``TransformerLayer`` at
    ``seq_len=77`` against ``ops.fused=torch``."""
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        TransformerLayer)
    from analytics_zoo_torch.tfpark.text import BERTClassifier
    sd = hf_bert_state(torch, dev, 20)
    loaded = []
    for _ in range(2):
        Layer.reset_name_counters()
        t0 = time.perf_counter()
        clf = BERTClassifier(num_classes=2, bert_checkpoint=sd,
                             seq_len=CLS_SEQ, **BERT_BASE)
        torch.cuda.synchronize()
        loaded.append((clf, time.perf_counter() - t0))
    a, b = loaded[0][0], loaded[1][0]
    n = check_loaded_bert(torch, a.model, sd)
    mp, ep = a.model.get_variables()["params"], \
        a.encoder.get_variables()["params"]
    if any(ep[l][k] is not mp[l][k] for l in ep for k in ep[l]):
        fail("the encoder's copies were not synced from the loaded model")
    feats = bert_features(CLS_BATCH, CLS_SEQ, 21)
    with deterministic(torch):
        pa = a.predict(feats, batch_size=CLS_BATCH)
        pb = b.predict(feats, batch_size=CLS_BATCH)
    if not np.array_equal(pa, pb):
        fail(f"two loads of one checkpoint predict differently: "
             f"{float(np.abs(pa - pb).max())}")
    print(f"16d load_bert_checkpoint (HF-named state_dict of BERT-base on "
          f"the card, through BERTClassifier(bert_checkpoint=)): {n} encoder "
          f"leaves bit-identical to their sources, the encoder's copies "
          f"synced; a second load predicts bit-identically; loads "
          f"{loaded[0][1]:.3f} s, {loaded[1][1]:.3f} s (draw of the head "
          f"included) ({card})")
    del loaded, a, b, sd

    Layer.reset_name_counters()
    tl = TransformerLayer.init_with_default_embedding(seq_len=ROUTE_SEQ)
    model = tl.build()
    model.init(torch.Generator().manual_seed(22))
    rs = np.random.RandomState(22)
    vocab = tl.cfg["vocab"]
    x = [rs.randint(0, vocab - ROUTE_SEQ, (8, ROUTE_SEQ)).astype(np.int64),
         np.broadcast_to(np.arange(vocab - ROUTE_SEQ, vocab),
                         (8, ROUTE_SEQ)).copy()]
    for compute in ("float32", "bfloat16"):
        dtypes.set_policy(compute_dtype=compute)
        kernels.reset_launch_counts()
        got = model.predict(x, batch_size=8)
        expect_launches(kernels.launch_counts(),
                        {"flash_attention_fwd": 12, "bias_gelu": 12},
                        f"TransformerLayer at seq_len {ROUTE_SEQ}")
        want = plain_route(lambda: model.predict(x, batch_size=8))
        diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        print(f"16d route difference, TransformerLayer (GPT-1 width, "
              f"seq_len {ROUTE_SEQ}, causal; the port's flash kernel, the "
              f"reference's dense attention) vs ops.fused=torch (dense), "
              f"{compute} products: max abs diff {diff:.3e} over the "
              f"sequence and pooled outputs (bound {MODEL_ATOL}), |states| "
              f"max {float(np.abs(want[0]).max()):.3e}")
        if not diff <= MODEL_ATOL:
            fail(f"route difference at seq_len {ROUTE_SEQ}: {diff}")
    dtypes.restore_policy(None)


def transformer_phase(torch, card, dev):
    """Phase 16: the Keras transformer models at full width.  Returns
    (launches of 16a's 4 requests, 16b's fit, 16c's fine-tuning) and the
    causal float32 flash kernels' times."""
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = gpt1_model(torch)
    n_params = sum(int(p.numel()) for p in
                   tree_leaves(model.get_variables()["params"]))
    print(f"16 GPT-1 (TransformerLayer.init_with_default_embedding, vocab "
          f"{GPT1['vocab']}, seq_len {GPT1_SEQ}, {GPT1['n_block']} blocks "
          f"of {GPT1['hidden_size']}, {GPT1['n_head']} heads; "
          f"TimeDistributed(Dense({GPT1_TOKENS}))): {n_params} params, "
          f"built and placed in {time.perf_counter() - t0:.1f} s")
    serve = gpt1_serving(torch, card, dev, model)
    train = gpt1_training(torch, card, dev, model)
    del model
    torch.cuda.empty_cache()
    times = causal_flash_times(torch, card, dev)
    torch.cuda.empty_cache()
    tune = bert_finetune(torch, card, dev)
    torch.cuda.empty_cache()
    checkpoint_and_route(torch, card, dev)
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return (serve, train, tune), times


# -------------- phase 17: the rest of the Keras surface, AnomalyDetector
# NAB's nyc_taxi.csv, which the reference's anomaly-detection notebook
# reads: half-hourly taxi passenger counts, 1 July 2014 - 31 January 2015
TAXI_POINTS = 10_320
TAXI_UNROLL = 24           # the taxi app's --unroll default
AD_BATCH = 128
AD_PREDICT_BATCH = 512
AD_EPOCHS = 3
AD_TIMED_STEPS = 30
AD_PREDICT_ATOL = 1e-5
AD_LOSS_ATOL = 1e-4
AD_CHECK_WINDOWS = 2048    # the zero-dropout card-against-CPU fit's rows
SWEEP_ATOL = 1e-5
REG_ATOL = 1e-5


def taxi_like_series(length: int, seed: int = 0):
    """Synthetic NYC-taxi-shaped demand with 6 injected incidents: the
    taxi app's generator (``apps/anomaly_detection``), value for value."""
    rs = np.random.RandomState(seed)
    t = np.arange(length, dtype=np.float32)
    daily = np.sin(2 * np.pi * t / 48.0)          # 48 samples/day
    weekly = 0.4 * np.sin(2 * np.pi * t / (48 * 7))
    series = 10.0 + 3.0 * daily + weekly + 0.15 * rs.randn(length)
    incidents = rs.choice(np.arange(100, length - 10), 6, replace=False)
    for i in incidents:
        series[i:i + 2] += rs.choice([-1, 1]) * 6.0   # spike or outage
    return series.astype(np.float32), sorted(int(i) for i in incidents)


@contextlib.contextmanager
def zoo_device(device):
    """Run the port's entry points on ``device`` (the zoo context moved
    there), then move the context back."""
    from analytics_zoo_torch.common.zoo_context import (
        get_zoo_context, init_zoo_context, reset_zoo_context)
    prior = get_zoo_context().device
    reset_zoo_context()
    init_zoo_context(device=device)
    try:
        yield
    finally:
        reset_zoo_context()
        init_zoo_context(device=prior)


def anomaly_detector(torch, dropouts=(0.2, 0.2, 0.2), variables=None):
    """AnomalyDetector at its default widths on the zoo context's device,
    auto-names from 1; ``variables`` (any device) replace its own."""
    from analytics_zoo_torch.models.anomalydetection import AnomalyDetector
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.topology import to_device
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    Layer.reset_name_counters()
    m = AnomalyDetector((TAXI_UNROLL, 1), dropouts=dropouts)
    m.model.init(torch.Generator().manual_seed(0))
    if variables is not None:
        m.set_variables(to_device(variables, get_zoo_context().device))
    return m


def anomaly_phase(torch, card, dev):
    """17a: AnomalyDetector trained and served on the card."""
    from analytics_zoo_torch.models.anomalydetection import (
        detect_anomalies, unroll)
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_leaves)
    series, incidents = taxi_like_series(TAXI_POINTS, seed=0)
    normed = (series - series.mean()) / (series.std() + 1e-8)
    x, y = unroll(normed, TAXI_UNROLL)
    split = int(len(x) * 0.8)
    steps = split // AD_BATCH
    model = anomaly_detector(torch)
    start = to_device(model.get_variables(), torch.device("cpu"))
    n_leaves = len(tree_leaves(start["params"]))
    model.compile(Adam(lr=0.01), "mse")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(x[:split], y[:split], batch_size=AD_BATCH,
                     nb_epoch=AD_EPOCHS, rng=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    expect_launches(kernels.launch_counts(),
                    {"fused_adam": AD_EPOCHS * steps},
                    "AnomalyDetector fit")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"AnomalyDetector fit losses {losses}")
    epoch_s = [h["wall_s"] for h in hist]
    print(f"17a AnomalyDetector (LSTM 8 -> 32 -> 15, dropouts 0.2, "
          f"Dense(1); {n_leaves} leaves) on the taxi series ({TAXI_POINTS} "
          f"half-hourly points, unroll {TAXI_UNROLL}: {len(x)} windows, "
          f"{split} to train): fit {AD_EPOCHS} epochs of {steps} steps "
          f"of {AD_BATCH} in {fit_s:.3f} s, losses {losses}, epoch s "
          f"{epoch_s} (the first with warm-up), 1 fused_adam launch a step "
          f"({card})")

    # the step alone, every step ending in a synchronize
    tr = DistributedTrainer(model.model, objectives.get("mse"),
                            optim_method=Adam(lr=0.01))
    params = tr.place_params(to_device(start, dev)["params"])
    opt_state = tr.init_opt_state(params)
    batch = tr.put_batch((x[:AD_BATCH], y[:AD_BATCH]))
    step_ms = []
    for i in range(AD_TIMED_STEPS + 3):       # 3 warm-up steps
        torch.cuda.synchronize()
        s = time.perf_counter()
        params, opt_state, _, loss = tr.train_step(
            params, opt_state, {}, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s) * 1e3)
    step_ms = step_ms[3:]
    q = np.percentile(step_ms, [0, 25, 50, 75, 100])
    print(f"17a step: median {q[2]:.3f} ms, quartiles {q[1]:.3f}-"
          f"{q[3]:.3f}, min {q[0]:.3f}, max {q[4]:.3f} over "
          f"{AD_TIMED_STEPS} steps of {AD_BATCH} windows "
          f"({AD_BATCH * 1e3 / q[2]:.1f} windows/s trained) ({card})")
    del tr, params, opt_state

    # predict, then the app's detection over the whole series
    model.predict(x[:AD_PREDICT_BATCH], batch_size=AD_PREDICT_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_pred = model.predict(x, batch_size=AD_PREDICT_BATCH)
    pred_s = time.perf_counter() - t0
    if y_pred.shape != (len(x), 1) or not np.isfinite(y_pred).all():
        fail(f"AnomalyDetector predict: shape {y_pred.shape}")
    flagged = detect_anomalies(y, y_pred, anomaly_size=2 * len(incidents))
    flagged_ts = sorted(int(i) + TAXI_UNROLL for i in flagged)
    recovered = [i for i in incidents
                 if any(abs(f - i) <= 2 for f in flagged_ts)]
    print(f"17a predict: {len(x)} windows at batch {AD_PREDICT_BATCH} in "
          f"{pred_s * 1e3:.3f} ms ({len(x) / pred_s:.1f} windows/s) "
          f"({card}); detect_anomalies flagged {len(flagged)}, "
          f"{len(recovered)} of the {len(incidents)} injected incidents "
          f"within 2 steps ({incidents})")

    # the card's predict against the CPU port's on the trained parameters
    trained = to_device(model.get_variables(), torch.device("cpu"))
    with zoo_device("cpu"):
        cpu = anomaly_detector(torch, variables=trained)
        y_cpu = cpu.predict(x, batch_size=AD_PREDICT_BATCH)
    err = float(np.abs(y_pred - y_cpu).max())
    print(f"17a predict card vs CPU: max abs diff {err:.3e} (tolerance "
          f"{AD_PREDICT_ATOL}), |y| max {float(np.abs(y_cpu).max()):.3e}")
    if not err <= AD_PREDICT_ATOL:
        fail(f"AnomalyDetector predict card vs CPU {err} > {AD_PREDICT_ATOL}")

    # a 2-epoch fit with the dropouts at zero, card against CPU
    xs, ys = x[:AD_CHECK_WINDOWS], y[:AD_CHECK_WINDOWS]
    runs = {}
    t_check = time.perf_counter()
    for where in ("card", "cpu"):
        with (zoo_device("cpu") if where == "cpu"
              else contextlib.nullcontext()):
            m = anomaly_detector(torch, (0.0, 0.0, 0.0), variables=start)
            m.compile(Adam(lr=0.01), "mse")
            runs[where] = [h["loss"] for h in m.fit(
                xs, ys, batch_size=AD_BATCH, nb_epoch=2, rng=1)]
    diff = max(abs(a - b) for a, b in zip(runs["card"], runs["cpu"]))
    print(f"17a zero-dropout fit, 2 epochs of {AD_CHECK_WINDOWS // AD_BATCH} "
          f"steps, card vs CPU: losses {runs['card']} vs {runs['cpu']}, "
          f"max abs diff {diff:.3e} (tolerance {AD_LOSS_ATOL})")
    if not diff <= AD_LOSS_ATOL:
        fail(f"AnomalyDetector fit card vs CPU {diff} > {AD_LOSS_ATOL}")
    return {"fused_adam": AD_EPOCHS * steps}


def sweep_cases():
    """(class, layer factory, inputs as numpy, what to check) for each of
    the 64 layer classes of phase 17b, at small shapes."""
    from analytics_zoo_torch.pipeline.api.keras import layers as L
    rs = np.random.RandomState(17)

    def x(*shape):
        return rs.randn(*shape).astype(np.float32)

    def pos(*shape):
        return np.abs(x(*shape)) + 0.1

    x3, x2 = x(4, 6, 8), x(4, 10)
    img, img_th, vol = x(2, 7, 6, 5), x(2, 5, 7, 6), x(2, 5, 4, 6, 3)
    ids = rs.randint(-1, 20, size=(5, 7)).astype(np.int32)
    sparse = np.where(rs.rand(4, 12) > 0.8, x(4, 12), 0).astype(np.float32)
    return [
        (L.Reshape((4, -1)), x3), (L.Permute((2, 1)), x3),
        (L.RepeatVector(3), x2), (L.Masking(0.0), np.where(
            np.arange(6)[None, :, None] % 3 == 0, 0, x3).astype(np.float32)),
        (L.Highway(), x3), (L.MaxoutDense(5, nb_feature=3), x2),
        (L.SparseDense(6, activation="tanh"), sparse),
        (L.LeakyReLU(0.2), x3), (L.ELU(0.7), x3),
        (L.ThresholdedReLU(0.5), x3), (L.PReLU(), x3), (L.SReLU(), x3),
        (L.Softmax(), x3),
        (L.AddConstant(1.5), x3), (L.MulConstant(-0.75), x3),
        (L.Exp(), x3), (L.Log(), pos(4, 6, 8)), (L.Sqrt(), pos(4, 6, 8)),
        (L.Square(), x3), (L.Power(1.5, scale=0.5, shift=0.2),
                           pos(4, 6, 8)),
        (L.Negative(), x3), (L.Identity(), x3), (L.Threshold(0.1, -0.5), x3),
        (L.BinaryThreshold(0.2), x3), (L.HardShrink(0.4), x3),
        (L.SoftShrink(0.4), x3), (L.HardTanh(-0.5, 0.8), x3),
        (L.RReLU(), x3), (L.CAdd((1, 6, 8)), x3), (L.CMul((1, 6, 1)), x3),
        (L.Mul(), x3), (L.Scale((1, 1, 8)), x3),
        (L.LRN2D(alpha=1e-2, dim_ordering="th"), img_th),
        (L.WithinChannelLRN2D(size=3), img),
        (L.ResizeBilinear(3, 10, dim_ordering="th"), img_th),
        (L.GaussianSampler(), [x(4, 5), x(4, 5)]),
        (L.GaussianNoise(0.5), x3), (L.GaussianDropout(0.3), x3),
        (L.SpatialDropout1D(0.4), x3), (L.SpatialDropout2D(0.4), img),
        (L.SpatialDropout3D(0.4), vol),
        (L.Select(1, 3), x3), (L.Narrow(1, 2, 4), x3),
        (L.Squeeze(0), x(3, 1, 5)), (L.ExpandDim(1), x3),
        (L.Expand((-1, 4, 8)), x(3, 6, 1, 8)), (L.SplitTensor(0, 3), x3),
        (L.SelectTable(1), [x(3, 4), x(3, 4)]), (L.Max(1), x3),
        (L.GetShape(), x3),
        (L.L2Normalization(), x3), (L.NormalizeScale(axis=1), img_th),
        (L.SparseEmbedding(20, 6, combiner="sqrtn", max_norm=0.5), ids),
        (L.SeparableConvolution2D(3, 2, 3, subsample=(2, 2),
                                  border_mode="same", depth_multiplier=2),
         img),
        (L.Deconvolution2D(3, 3, 3, subsample=(2, 2), border_mode="same"),
         img),
        (L.Cropping1D((1, 2)), x3), (L.Cropping2D(((1, 2), (0, 1))), img),
        (L.Cropping3D(), vol), (L.UpSampling1D(3), x3),
        (L.UpSampling2D((2, 3)), img), (L.UpSampling3D((1, 2, 2)), vol),
        (L.ShareConvolution2D(4, 3, 3, pad_h=1, pad_w=2), img),
        (L.LocallyConnected1D(5, 3), x3),
        (L.LocallyConnected2D(4, 2, 3, subsample=(2, 2)), img),
    ]


def _graph(layer, inputs):
    from analytics_zoo_torch.pipeline.api.keras import Input, Model
    if isinstance(inputs, list):
        ins = [Input(shape=a.shape[1:]) for a in inputs]
        return Model(ins, layer(ins))
    inp = Input(shape=inputs.shape[1:])
    return Model(inp, layer(inp))


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def layer_sweep(torch, dev):
    """17b: each of the 64 new layer classes on the card against the same
    layer on the CPU: forward, and for float inputs the gradients of
    sum(out * ct) with respect to the parameters and the input; then the
    random layers' training paths by their statistics on the card."""
    from analytics_zoo_torch.pipeline.api.keras import layers as L
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_replace)
    Layer.reset_name_counters()
    cases = sweep_cases()
    classes = {type(layer).__name__ for layer, _ in cases}
    if len(classes) != 64:
        fail(f"phase 17b sweeps {len(classes)} classes, not 64")
    worst, loose, n_checked = 0.0, [], 0
    cpu = torch.device("cpu")
    for layer, inputs in cases:
        name = type(layer).__name__
        model = _graph(layer, inputs)
        shapes = [tuple(p.shape) for p in tree_leaves(
            model.init(torch.Generator().manual_seed(0))["params"])]
        rs = np.random.RandomState(7)
        vals = [torch.from_numpy((rs.randn(*s) * 0.5).astype(np.float32))
                for s in shapes]
        results = []                           # the CPU's, then the card's
        for where in (cpu, dev):
            ps = [v.to(where).requires_grad_() for v in vals]
            params = tree_replace(model.get_variables()["params"], ps)
            xs = [torch.from_numpy(a).to(where) for a in _as_list(inputs)]
            grad_x = [a for a in xs if a.is_floating_point()]
            for a in grad_x:
                a.requires_grad_()
            out, _ = model.apply(params, xs if isinstance(inputs, list)
                                 else xs[0])
            outs = _as_list(out)
            floats = [o for o in outs if o.is_floating_point()]
            wrt = ps + grad_x
            grads = []
            if floats and wrt and any(o.requires_grad for o in floats):
                cts = [torch.from_numpy(np.random.RandomState(11).randn(
                    *o.shape).astype(np.float32)).to(where) for o in floats]
                loss = sum((o * c).sum() for o, c in zip(floats, cts))
                grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                            materialize_grads=True)
            results.append([t.detach().cpu() for t in
                            list(outs) + list(grads)])
            if any(t.device.type != where.type for t in outs):
                fail(f"phase 17b {name}: an output left {where}")
        err = 0.0
        for want, got in zip(*results):
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"phase 17b {name}: {got.dtype}{tuple(got.shape)} on "
                     f"the card, {want.dtype}{tuple(want.shape)} on the CPU")
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    fail(f"phase 17b {name}: integer outputs differ")
                continue
            d = float((got - want).abs().max()) if want.numel() else 0.0
            # SWEEP_ATOL absolute, relative to the magnitude above 1 (the
            # convolutions' gradients are sums over every position)
            tol = SWEEP_ATOL * max(1.0, float(want.abs().max()))
            if not d <= tol:
                fail(f"phase 17b {name}: card vs CPU {d:.3e} > {tol:.3e}")
            err = max(err, d)
        n_checked += 1
        worst = max(worst, err)
        if err > 1e-6:
            loose.append((name, err))
    print(f"17b layer sweep: {n_checked} layers (64 classes) checked on the "
          f"card against the CPU, forward and gradients, largest difference "
          f"{worst:.3e} (tolerance {SWEEP_ATOL}, scaled by the magnitude "
          f"above 1)")
    for name, err in loose:
        print(f"17b {name}: card vs CPU {err:.3e}")

    # the random layers' training paths on the card, by their statistics
    gen = torch.Generator(device=dev).manual_seed(17)
    xs = torch.rand(100, 2000, generator=gen, device=dev) + 0.1
    n = xs.numel()

    def moments(d, mean, std, what):
        m, s = float(d.mean()), float(d.std())
        if not (abs(m - mean) < 5 * std / n ** 0.5 and
                abs(s - std) < 5 * std / (2 * n) ** 0.5):
            fail(f"phase 17b {what}: mean {m} std {s}, want {mean} {std}")
        return m, s

    r = [moments((L.GaussianNoise(0.5).call({}, xs, True, gen) - xs) / 0.5,
                 0.0, 1.0, "GaussianNoise"),
         moments(L.GaussianDropout(0.3).call({}, xs, True, gen) / xs, 1.0,
                 (0.3 / 0.7) ** 0.5, "GaussianDropout"),
         moments(L.RReLU(0.1, 0.4).call({}, -xs, True, gen) / -xs, 0.25,
                 0.3 / 12 ** 0.5, "RReLU"),
         moments((L.GaussianSampler().call({}, [xs, xs], True, gen) - xs)
                 / torch.exp(xs * 0.5), 0.0, 1.0, "GaussianSampler")]
    vol = torch.rand(400, 3, 3, 3, 50, generator=gen, device=dev) + 0.1
    out = L.SpatialDropout3D(0.3).call({}, vol, True, gen)
    kept = (out != 0).reshape(400, -1, 50)
    if not bool((kept == kept[:, :1]).all()):
        fail("phase 17b SpatialDropout3D: a channel's mask varies")
    rate = float(kept[:, 0].float().mean())
    if abs(rate - 0.7) > 5 * (0.21 / 20000) ** 0.5:
        fail(f"phase 17b SpatialDropout3D keep rate {rate}")
    print(f"17b random layers in training on the card: GaussianNoise, "
          f"GaussianDropout, RReLU, GaussianSampler (mean, std) {r}; "
          f"SpatialDropout3D keep rate {rate:.4f} (0.7), one draw a channel")
    return n_checked, worst


def regularizer_check(torch, dev):
    """17c: a regularized Sequential, 3 Adam steps on the card and on the
    CPU: the same parameters, and history losses without the penalty."""
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras import layers as L
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.regularizers import (
        l1l2, l2)
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_leaves)
    from analytics_zoo_torch.ops import kernels

    def build(start=None):
        Layer.reset_name_counters()
        m = Sequential()
        m.add(L.Convolution1D(8, 3, input_shape=(12, 6),
                              W_regularizer=l2(1e-2)))
        m.add(L.LSTM(6, W_regularizer=l2(1e-2), U_regularizer=l1l2(
            1e-3, 1e-2)))
        m.add(L.Dense(3, W_regularizer=l1l2(1e-2, 2e-2),
                      b_regularizer=l2(3e-2)))
        m.init(torch.Generator().manual_seed(3))
        if start is not None:
            from analytics_zoo_torch.common.zoo_context import (
                get_zoo_context)
            m.set_variables(to_device(start, get_zoo_context().device))
        # Adam's first steps are lr * g / (|g| + eps): eps 1e-3 keeps them a
        # well-conditioned function of g where a gradient cancels near 0
        m.compile(Adam(lr=1e-2, epsilon=1e-3), "mse")
        return m

    rs = np.random.RandomState(18)
    x = rs.randn(64, 12, 6).astype(np.float32)
    y = rs.randn(64, 3).astype(np.float32)
    card = build()
    start = to_device(card.get_variables(), torch.device("cpu"))
    kernels.reset_launch_counts()
    hist = card.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False, rng=0)
    expect_launches(kernels.launch_counts(), {"fused_adam": 3},
                    "regularized fit")
    with zoo_device("cpu"):
        cpu = build(start)
        cpu_hist = cpu.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False,
                           rng=0)
        p0 = start["params"]
        out, _ = cpu.apply(p0, torch.from_numpy(x))
        loss0 = float(objectives.get("mse")(torch.from_numpy(y), out))
        penalty0 = float(cpu.regularization_loss(p0))
        got = tree_leaves(cpu.get_variables()["params"])
    want = [t.cpu() for t in tree_leaves(card.get_variables()["params"])]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    moved = max(float((a - b).abs().max()) for a, b in
                zip(want, tree_leaves(start["params"])))
    losses = [h["loss"] for h in hist]
    d_loss = max(abs(a - b["loss"]) for a, b in zip(losses, cpu_hist))
    print(f"17c regularizers (Convolution1D W l2, LSTM W l2 + U l1l2, Dense "
          f"W l1l2 + b l2), 3 Adam steps of 64: parameters card vs CPU "
          f"{err:.3e} (tolerance {REG_ATOL}; moved {moved:.3e}), history "
          f"losses {losses} (CPU {d_loss:.3e} apart); the first is the "
          f"loss without the penalty {loss0:.6f} (penalty {penalty0:.6f})")
    if not err <= REG_ATOL or not d_loss <= REG_ATOL:
        fail(f"regularized fit card vs CPU: params {err}, losses {d_loss}")
    if not abs(losses[0] - loss0) <= REG_ATOL or \
            not penalty0 > 100 * REG_ATOL:
        fail(f"history loss {losses[0]} is not the loss {loss0} without "
             f"the penalty {penalty0}")


def keras_surface_phase(torch, card, dev):
    """Phase 17, under float32 products: AnomalyDetector trained and
    served, the 64-class layer sweep, the regularizers.  Returns 17a's
    launches."""
    from analytics_zoo_torch.ops import dtypes
    t_phase = time.perf_counter()
    dtypes.set_policy(compute_dtype="float32")
    try:
        launches = anomaly_phase(torch, card, dev)
        layer_sweep(torch, dev)
        regularizer_check(torch, dev)
    finally:
        dtypes.restore_policy(None)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 18
def qa_relations(n_questions: int, n_neg: int, vocab_size: int, seed: int):
    """Synthetic QA relations by the qaranker example's scheme
    (``examples/qaranker/qa_ranker.py``): each question is 3 of 4 theme
    words, its relevant answer the 4 themes and 4 random words, each of
    its ``n_neg`` irrelevant answers 8 random words, over a vocabulary of
    ``vocab_size`` words; at 3 negatives and 200 words, the example's."""
    rs = np.random.RandomState(seed)
    # an array once (the example passes a list, which ``choice`` converts
    # at every call: the same draws, 20,000 words converted 22,528 times)
    vocab = np.array([f"w{i}" for i in range(vocab_size)])
    q_corpus, a_corpus, relations = {}, {}, []
    aid = 0
    for qi in range(n_questions):
        theme = rs.choice(vocab, 4, replace=False)
        qid = f"q{qi}"
        q_corpus[qid] = " ".join(theme[:3])
        pos = f"a{aid}"
        aid += 1
        a_corpus[pos] = " ".join(np.concatenate(
            [theme, rs.choice(vocab, 4)]))
        relations.append((qid, pos, 1))
        for _ in range(n_neg):
            neg = f"a{aid}"
            aid += 1
            a_corpus[neg] = " ".join(rs.choice(vocab, 8))
            relations.append((qid, neg, 0))
    return relations, q_corpus, a_corpus


def qa_word_index(q_corpus, a_corpus):
    """The word index over both corpora, through the port's ``TextSet``."""
    from analytics_zoo_torch.feature.text import TextSet
    return (TextSet.from_texts(list(q_corpus.values()) +
                               list(a_corpus.values()))
            .tokenize().normalize().word2idx().word_index)


def _qa_ids(texts, word_index, length):
    from analytics_zoo_torch.feature.text import TextSet
    ts = (TextSet.from_texts(texts).tokenize().normalize()
          .word2idx(existing_map=word_index)
          .shape_sequence(length, trunc_mode="post"))
    return ts.to_arrays()[0]


def qa_pair_arrays(relations, q_corpus, a_corpus, q_len, a_len):
    """``(q, a, y, word_index)``: the interleaved (pos, neg) pairs of
    ``TextSet.from_relation_pairs`` as fixed-length ids, as the example
    builds them (question and answer split at the pair's separator)."""
    from analytics_zoo_torch.feature.text import TextSet
    wi = qa_word_index(q_corpus, a_corpus)
    pairs = TextSet.from_relation_pairs(relations, q_corpus, a_corpus)
    split = [f.text.split(" \t ") for f in pairs.features]
    q = _qa_ids([s[0] for s in split], wi, q_len)
    a = _qa_ids([s[1] for s in split], wi, a_len)
    y = np.asarray([f.label for f in pairs.features],
                   np.float32).reshape(-1, 1)
    return q, a, y, wi


def qa_rank_arrays(relations, q_corpus, a_corpus, q_len, a_len, wi=None):
    """``(q, a)`` ids of every relation, in order, for ``score_pairs``
    (``wi`` the word index, when the caller has it)."""
    wi = wi if wi is not None else qa_word_index(q_corpus, a_corpus)
    return (_qa_ids([q_corpus[r[0]] for r in relations], wi, q_len),
            _qa_ids([a_corpus[r[1]] for r in relations], wi, a_len))


KNRM_Q_LEN, KNRM_A_LEN = 10, 40   # the qaranker example's defaults
KNRM_EMBED = 300                  # KNRM.scala's default
KNRM_KERNELS = 21
KNRM_QUESTIONS = 2048
KNRM_NEG = 9
KNRM_VOCAB = 20_000
KNRM_BATCH = 256
KNRM_EPOCHS = 3
KNRM_TIMED_STEPS = 30
# Card against CPU scores, relative to their scale: a score sums 21
# log-kernel features over 10 query terms in float32 to ~38, where an ulp
# is 3.8e-6, in another order on each device (1.144e-05 absolute on the
# H100)
KNRM_ATOL = 1e-5
# Switch-Base (Fedus et al. 2021): d_model 768, d_ff 3072, 8 experts,
# top-1, capacity factor 1.25
MOE_D, MOE_FF, MOE_EXPERTS, MOE_CF = 768, 3072, 8, 1.25
MOE_BATCH, MOE_SEQ = 8, 512
MOE_STEPS = 4
MOE_ATOL = 1e-5
# Shi et al. 2015, Moving MNIST: 16 x 16 patch tensors of 16 values,
# 10 frames, three ConvLSTM layers of 128, 64 and 64 filters, 5 x 5
CLSTM_BATCH, CLSTM_FRAMES, CLSTM_SIZE, CLSTM_CHANNELS = 16, 10, 16, 16
CLSTM_FILTERS = (128, 64, 64)
CLSTM_KERNEL = 5
CLSTM_GRAD_ROWS = 2
CLSTM_ATOL = 1e-4
CLSTM_GRAD_RTOL = 1e-4
SWITCH_STEPS = 4
GROUP_ROWS = 2                    # the groups' card-against-CPU step


def zero_dropout(net) -> None:
    """Every dropout of ``net`` at 0: the card's and the CPU's generators
    draw different masks."""
    for layer in net.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0
        if hasattr(layer, "layers"):
            zero_dropout(layer)


def knrm_model(embedding_matrix):
    from analytics_zoo_torch.models.textmatching import KNRM
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    Layer.reset_name_counters()
    return KNRM(KNRM_Q_LEN, KNRM_A_LEN, vocab_size=KNRM_VOCAB,
                embed_size=KNRM_EMBED, embedding_matrix=embedding_matrix,
                train_embed=True, kernel_num=KNRM_KERNELS, sigma=0.1,
                exact_sigma=0.001)


def knrm_phase(torch, card, dev):
    """18a: KNRM trained and ranked at its published width."""
    from analytics_zoo_torch.models.common_ranker import (
        evaluate_map, evaluate_ndcg)
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_leaves)
    t0 = time.perf_counter()
    relations, qc, ac = qa_relations(KNRM_QUESTIONS, KNRM_NEG, KNRM_VOCAB,
                                     seed=0)
    q, a, y, wi = qa_pair_arrays(relations, qc, ac, KNRM_Q_LEN, KNRM_A_LEN)
    rq, ra = qa_rank_arrays(relations, qc, ac, KNRM_Q_LEN, KNRM_A_LEN, wi)
    emb = (np.random.RandomState(0).randn(KNRM_VOCAB + 1, KNRM_EMBED)
           * 0.1).astype(np.float32)
    print(f"18a data: {KNRM_QUESTIONS} questions x (1 + {KNRM_NEG}) "
          f"answers over {KNRM_VOCAB} words ({len(wi)} indexed), "
          f"{len(y)} interleaved pair rows, {len(relations)} relations to "
          f"rank, in {time.perf_counter() - t0:.2f} s (host)")
    model = knrm_model(emb)
    model.model.init(torch.Generator().manual_seed(0))
    start = to_device(model.get_variables(), torch.device("cpu"))
    n_leaves = len(tree_leaves(start["params"]))
    before = model.score_pairs(rq, ra)
    map0 = evaluate_map(relations, before)
    ndcg0 = evaluate_ndcg(relations, before, k=3)
    model.compile(Adam(lr=1e-3), "rank_hinge")
    steps = len(y) // KNRM_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit([q, a], y, batch_size=KNRM_BATCH, nb_epoch=KNRM_EPOCHS,
                     shuffle=False, rng=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": KNRM_EPOCHS * steps},
                    "KNRM fit")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"KNRM fit losses {losses}")
    print(f"18a KNRM (text1 {KNRM_Q_LEN}, text2 {KNRM_A_LEN}, embed "
          f"{KNRM_EMBED} trainable, {KNRM_KERNELS} kernels, sigma 0.1, "
          f"exact 0.001; {n_leaves} leaves) fit {KNRM_EPOCHS} epochs of "
          f"{steps} steps of {KNRM_BATCH} rows, rank_hinge, "
          f"shuffle=False, in {fit_s:.3f} s, losses {losses}, epoch s "
          f"{[h['wall_s'] for h in hist]} (the first with warm-up); "
          f"launches {launches} ({card})")

    tr = DistributedTrainer(model.model, objectives.get("rank_hinge"),
                            optim_method=Adam(lr=1e-3))
    params = tr.place_params(to_device(start, dev)["params"])
    opt_state = tr.init_opt_state(params)
    batch = tr.put_batch(([q[:KNRM_BATCH], a[:KNRM_BATCH]], y[:KNRM_BATCH]))
    step_ms = []
    for i in range(KNRM_TIMED_STEPS + 3):       # 3 warm-up steps
        torch.cuda.synchronize()
        s = time.perf_counter()
        params, opt_state, _, loss = tr.train_step(
            params, opt_state, {}, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s) * 1e3)
    step_ms = step_ms[3:]
    qs = np.percentile(step_ms, [0, 25, 50, 75, 100])
    print(f"18a step: median {qs[2]:.3f} ms, quartiles {qs[1]:.3f}-"
          f"{qs[3]:.3f}, min {qs[0]:.3f}, max {qs[4]:.3f} over "
          f"{KNRM_TIMED_STEPS} steps of {KNRM_BATCH // 2} pairs "
          f"({KNRM_BATCH // 2 * 1e3 / qs[2]:.1f} pairs/s trained) ({card})")
    del tr, params, opt_state

    model.score_pairs(rq[:1024], ra[:1024])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = model.score_pairs(rq, ra)
    score_s = time.perf_counter() - t0
    map1 = evaluate_map(relations, scores)
    ndcg1 = evaluate_ndcg(relations, scores, k=3)
    print(f"18a score_pairs: {len(rq)} rows at batch 1024 in "
          f"{score_s * 1e3:.3f} ms ({len(rq) / score_s:.1f} rows/s) "
          f"({card}); MAP {map0:.4f} -> {map1:.4f}, NDCG@3 {ndcg0:.4f} -> "
          f"{ndcg1:.4f} (untrained -> trained)")
    if not (map1 > map0 and ndcg1 > ndcg0):
        fail(f"KNRM ranking did not improve: MAP {map0} -> {map1}, "
             f"NDCG@3 {ndcg0} -> {ndcg1}")
    trained = to_device(model.get_variables(), torch.device("cpu"))
    with zoo_device("cpu"):
        cpu = knrm_model(emb)
        cpu.set_variables(trained)
        cpu_scores = cpu.score_pairs(rq, ra)
    err = float(np.abs(scores - cpu_scores).max())
    scale = max(float(np.abs(cpu_scores).max()), 1.0)
    cpu_map = evaluate_map(relations, cpu_scores)
    print(f"18a score_pairs card vs CPU on the trained weights: max abs "
          f"diff {err:.3e} (tolerance {KNRM_ATOL} of the scores' scale "
          f"{scale:.3e}), MAP {map1:.4f} vs {cpu_map:.4f}")
    if not (err <= KNRM_ATOL * scale and cpu_map == map1):
        fail(f"KNRM score_pairs card vs CPU {err} > {KNRM_ATOL} x {scale}, "
             f"MAP {map1} vs {cpu_map}")
    return launches


class MoENet:
    """One ``MoE`` layer as a trainable model whose output is
    ``call_with_aux``'s ``[y, aux]``."""

    def __init__(self, layer):
        self.layer = layer

    def apply(self, params, x, state=None, training=False, rng=None):
        y, aux = self.layer.call_with_aux(params["moe"], x)
        return [y, aux], state

    def regularization_loss(self, params):
        return 0.0


def moe_loss(y, out):
    from analytics_zoo_torch.pipeline.api.keras import objectives
    return objectives.get("mse")(y, out[0]) + 1e-2 * out[1]


def moe_routing(torch, layer, params, x):
    """(kept slots per token, combine > 0) of ``layer``'s routing of
    ``x``: which expert and slot each token took."""
    from analytics_zoo_torch.pipeline.api.keras.layers import moe as tmoe
    xt = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        probs = torch.softmax(
            tmoe._low_matmul(xt, params["router"]).float(), dim=-1)
        combine, _ = layer._route(probs, xt.shape[0])
    used = combine > 0
    return used.sum(dim=(1, 2)), used


def moe_check(torch, what, layer, params, x, atol):
    """The layer's output and aux on the card against the CPU on the same
    weights and inputs.  A token whose routing differs (a near tie of two
    router probabilities resolved the other way) is counted and left out
    of the output's comparison; at most one in a thousand may differ."""
    from analytics_zoo_torch.pipeline.api.keras.topology import to_device
    cpu_p = to_device(params, torch.device("cpu"))
    with torch.no_grad():
        y, aux = layer.call_with_aux(params, x)
        y_cpu, aux_cpu = layer.call_with_aux(cpu_p, x.cpu())
    _, used = moe_routing(torch, layer, params, x)
    _, used_cpu = moe_routing(torch, layer, cpu_p, x.cpu())
    same = (used.cpu() == used_cpu).flatten(1).all(dim=1)
    n = int(same.numel())
    differ = n - int(same.sum())
    d = x.shape[-1]
    err = float((y.cpu().reshape(-1, d)[same] -
                 y_cpu.reshape(-1, d)[same]).abs().max())
    aux_err = abs(float(aux) - float(aux_cpu))
    aux_tol = 1e-6 + differ * layer.num_experts / n
    print(f"{what} card vs CPU: output max abs diff {err:.3e} (tolerance "
          f"{atol}) over {n - differ} of {n} tokens ({differ} routed "
          f"otherwise), aux {float(aux):.6f} vs {float(aux_cpu):.6f} "
          f"(tolerance {aux_tol:.2e})")
    if not (err <= atol and differ <= n // 1000 and aux_err <= aux_tol):
        fail(f"{what} card vs CPU: output {err}, {differ} tokens routed "
             f"otherwise, aux {aux_err}")


def moe_phase(torch, card, dev):
    """18b: MoE at Switch-Base's widths, 4 Adam steps of call_with_aux."""
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import MoE
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    Layer.reset_name_counters()
    layer = MoE(MOE_EXPERTS, MOE_FF, top_k=1, capacity_factor=MOE_CF)
    params = {"moe": layer.init(torch.Generator().manual_seed(0),
                                (None, MOE_SEQ, MOE_D))["params"]}
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((MOE_BATCH, MOE_SEQ, MOE_D), generator=gen, device=dev)
    y = torch.randn((MOE_BATCH, MOE_SEQ, MOE_D), generator=gen, device=dev)
    tokens = MOE_BATCH * MOE_SEQ
    net = MoENet(layer)
    tr = DistributedTrainer(net, moe_loss, optim_method=Adam(lr=1e-3))
    p = tr.place_params(params)
    moe_check(torch, "18b MoE forward (untrained)", layer, p["moe"], x,
              MOE_ATOL)
    opt_state = tr.init_opt_state(p)
    kernels.reset_launch_counts()
    step_ms, losses, dropped, auxes = [], [], [], []
    for i in range(MOE_STEPS):
        kept, _ = moe_routing(torch, layer, p["moe"], x)
        dropped.append(int((kept == 0).sum()))
        torch.cuda.synchronize()
        s = time.perf_counter()
        p, opt_state, _, loss = tr.train_step(
            p, opt_state, {}, (x, y), step_generator(0, i, dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s) * 1e3)
        losses.append(float(loss))
        auxes.append(float(layer.aux_loss().detach()))
    expect_launches(kernels.launch_counts(), {"fused_adam": MOE_STEPS},
                    "MoE steps")
    if not all(np.isfinite(losses)):
        fail(f"MoE losses {losses}")
    print(f"18b MoE (d_model {MOE_D}, d_ff {MOE_FF}, {MOE_EXPERTS} experts, "
          f"top-1, capacity factor {MOE_CF}: {layer._capacity(tokens)} slots "
          f"an expert for {tokens} tokens) {MOE_STEPS} Adam steps of mse + "
          f"1e-2 aux: ms {[round(v, 3) for v in step_ms]} (the first with "
          f"warm-up), median of the last {MOE_STEPS - 1} "
          f"{statistics.median(step_ms[1:]):.3f} ms "
          f"({tokens * 1e3 / statistics.median(step_ms[1:]):.1f} tokens/s), "
          f"tokens dropped {dropped}, aux {auxes}, losses {losses}, "
          f"1 fused_adam launch a step ({card})")
    moe_check(torch, "18b MoE forward (after the steps)", layer, p["moe"],
              x, MOE_ATOL)
    # top-2 at a small width, with overflow: checks only
    small = MoE(4, 64, top_k=2, capacity_factor=0.75)
    sp = small.init(torch.Generator().manual_seed(1), (None, 32))["params"]
    sp = {k: v.to(dev) for k, v in sp.items()}
    xs = torch.randn((4, 64, 32), generator=gen, device=dev)
    moe_check(torch, "18b MoE top-2 (4 experts, capacity factor 0.75)",
              small, sp, xs, 1e-5)
    kept, _ = moe_routing(torch, small, sp, xs)
    print(f"18b top-2: slots kept per token {torch.bincount(kept.cpu()).tolist()}"
          f" (0, 1 or 2 of the 2 choices)")
    return {"fused_adam": MOE_STEPS}


def convlstm_net(torch, filters, kernel, input_shape, seed=0):
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        ConvLSTM2D, ConvLSTM3D)
    Layer.reset_name_counters()
    cls = ConvLSTM2D if len(input_shape) == 4 else ConvLSTM3D
    net = Sequential()
    for i, f in enumerate(filters):
        last = i == len(filters) - 1
        kw = {"input_shape": input_shape} if i == 0 else {}
        net.add(cls(f, kernel, return_sequences=not last, **kw))
    net.init(torch.Generator().manual_seed(seed))
    return net


def convlstm_grads(torch, net, params, x, w):
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_replace)
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    out, _ = net.apply(tree_replace(params, live), x)
    (out * w).sum().backward()
    return out.detach(), [t.grad for t in live]


def convlstm_check(torch, what, net, x):
    """Forward and gradients of the first ``CLSTM_GRAD_ROWS`` rows on the
    card against the CPU on the same weights."""
    from analytics_zoo_torch.pipeline.api.keras.topology import to_device
    params = net.get_variables()["params"]
    cpu_p = to_device(params, torch.device("cpu"))
    rows = x[:CLSTM_GRAD_ROWS]
    w = torch.randn(tuple(net.get_output_shape()[1:]),
                    generator=torch.Generator().manual_seed(3))
    o, g = convlstm_grads(torch, net, params, rows, w.to(rows.device))
    o_cpu, g_cpu = convlstm_grads(torch, net, cpu_p, rows.cpu(), w)
    err = float((o.cpu() - o_cpu).abs().max())
    grad_err = max(rel_l2(a.cpu(), b) for a, b in zip(g, g_cpu))
    print(f"{what} card vs CPU on {CLSTM_GRAD_ROWS} rows: output max abs "
          f"diff {err:.3e} (tolerance {CLSTM_ATOL}), gradients of {len(g)} "
          f"leaves relative L2 max {grad_err:.3e} (tolerance "
          f"{CLSTM_GRAD_RTOL})")
    if not (err <= CLSTM_ATOL and grad_err <= CLSTM_GRAD_RTOL):
        fail(f"{what} card vs CPU: output {err}, gradients {grad_err}")


def convlstm_phase(torch, card, dev):
    """18c: ConvLSTM2D at Shi et al.'s Moving-MNIST width; ConvLSTM3D
    small (float32 products)."""
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_replace)
    shape = (CLSTM_FRAMES, CLSTM_SIZE, CLSTM_SIZE, CLSTM_CHANNELS)
    net = convlstm_net(torch, CLSTM_FILTERS, CLSTM_KERNEL, shape)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((CLSTM_BATCH,) + shape, generator=gen, device=dev)
    params = net.get_variables()["params"]
    target = torch.rand((CLSTM_BATCH,) + tuple(net.get_output_shape()[1:]),
                        generator=gen, device=dev)
    ms = []
    for _ in range(3):                       # the first with warm-up
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        torch.cuda.synchronize()
        s = time.perf_counter()
        out, _ = net.apply(tree_replace(params, live), x, training=True)
        loss = torch.mean(torch.square(out - target))
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - s) * 1e3)
    if not (np.isfinite(float(loss.detach())) and
            all(bool(torch.isfinite(g).all()) for g in grads)):
        fail("ConvLSTM2D forward and backward not finite")
    print(f"18c ConvLSTM2D stack {CLSTM_FILTERS} filters, {CLSTM_KERNEL}x"
          f"{CLSTM_KERNEL}, on {CLSTM_BATCH} x {CLSTM_FRAMES} frames of "
          f"{CLSTM_SIZE}x{CLSTM_SIZE}x{CLSTM_CHANNELS}: forward + backward "
          f"ms {[round(v, 3) for v in ms]} (the first with warm-up), "
          f"output {tuple(out.shape)}, loss {float(loss.detach()):.6f} "
          f"({card})")
    convlstm_check(torch, "18c ConvLSTM2D", net, x)
    small = convlstm_net(torch, (4, 3), 3, (4, 6, 5, 4, 3), seed=1)
    xs = torch.rand((3, 4, 6, 5, 4, 3), generator=gen, device=dev)
    convlstm_check(torch, "18c ConvLSTM3D (4, 3 filters, 3x3x3)", small, xs)


def bert_steps(torch, model, start, batch, remat, steps):
    """``steps`` train steps of ``model`` from ``start`` with train.remat
    ``remat``: (params, step ms, peak bytes above the bytes allocated at
    the turn's start)."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    get_config().set("train.remat", remat)
    try:
        tr = DistributedTrainer(
            model.model, objectives.get(
                "sparse_categorical_crossentropy_with_logits"),
            optim_method=Adam(lr=1e-4))
    finally:
        get_config().set("train.remat", False)
    params = tr.place_params(start["params"])
    opt_state = tr.init_opt_state(params)
    state = start["state"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        s = time.perf_counter()
        params, opt_state, state, loss = tr.train_step_at(
            params, opt_state, state, batch, seed=0, step=i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - s) * 1e3)
    return params, ms, torch.cuda.max_memory_allocated() - base


def switches_phase(torch, card, dev):
    """18d: train.remat, freezing and optimizer groups at BERT-base
    width."""
    from analytics_zoo_torch.common.triggers import MaxEpoch
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_leaves)
    from analytics_zoo_torch.pipeline.estimator import Estimator
    rs = np.random.RandomState(18)
    x = rs.randint(0, 30522, size=(16, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(16,)).astype(np.int64)
    Layer.reset_name_counters()
    model = bert_base()
    model.model.init(torch.Generator().manual_seed(0))
    start = model.get_variables()
    tr = DistributedTrainer(model.model, None)
    batch = tr.put_batch((x[:8], y[:8]))
    ref, worst, launches = None, 0.0, {}
    with deterministic(torch):
        for remat in (False, True, True, False):
            kernels.reset_launch_counts()
            params, ms, peak = bert_steps(torch, model, start, batch, remat,
                                          SWITCH_STEPS)
            launches[remat] = kernels.launch_counts()
            leaves = tree_leaves(params)
            ref = ref if ref is not None else leaves
            diff = max(float((a - b).abs().max())
                       for a, b in zip(leaves, ref))
            worst = max(worst, diff)
            del params, leaves
            print(f"18d train.remat={remat}: {SWITCH_STEPS} steps of 8 x 512, "
                  f"ms {[round(v, 3) for v in ms]} (median "
                  f"{statistics.median(ms[1:]):.3f} of the last "
                  f"{SWITCH_STEPS - 1}), peak memory above the turn's start "
                  f"{peak / 2 ** 30:.3f} GiB, launches {launches[remat]}, "
                  f"params max abs diff from the first remat=False turn "
                  f"{diff:.3e} ({card})")
    plain, again = launches[False], launches[True]
    fwd = ("flash_attention_fwd", "bias_gelu", "layernorm_act")
    if any(again[k] < plain[k] * 3 // 2 for k in fwd) or any(
            again[k] != plain[k] for k in plain if k not in fwd):
        fail(f"remat launches {again} against {plain}: the forward's "
             "kernels should run again in the recompute")
    if worst != 0.0:
        fail(f"train.remat params differ from the plain steps by {worst} "
             "under deterministic algorithms")
    print("18d train.remat: params bit-identical to the plain steps in "
          "every turn")
    del ref

    # freeze_up_to the encoder's pooling, then fit on the fused Adam
    pool = next(l.name for l in model.model.layers
                if type(l).__name__ == "GlobalMaxPooling1D")
    model.set_variables(to_device(start, dev))
    model.model.freeze_up_to(pool)
    frozen = model.model.frozen_layer_names()
    before = {k: [t.clone() for t in tree_leaves(start["params"][k])]
              for k in frozen}
    model.compile(Adam(lr=1e-4), "sparse_categorical_crossentropy_with_logits")
    kernels.reset_launch_counts()
    model.fit(x, y, batch_size=8, nb_epoch=1, rng=0)
    launches = kernels.launch_counts()
    after = model.get_variables()["params"]
    moved = sum(not torch.equal(a, b) for k in frozen
                for a, b in zip(before[k], tree_leaves(after[k])))
    live = [k for k in after if k not in frozen]
    changed = sum(not torch.equal(a, b) for k in live
                  for a, b in zip(tree_leaves(start["params"][k]),
                                  tree_leaves(after[k])))
    print(f"18d freeze_up_to({pool!r}): {len(frozen)} of "
          f"{len(model.model.layers)} layers frozen, {moved} frozen leaves "
          f"moved, {changed} live leaves moved, fit 2 steps, launches "
          f"{launches}")
    if moved or not changed or launches["fused_adam"] != 2:
        fail(f"freeze_up_to fit: {moved} frozen leaves moved, {changed} "
             f"live leaves moved, launches {launches}")
    model.model.unfreeze()

    # two optimizer groups, card against CPU, float32 products, no dropout
    heads = [l.name for l in model.model.layers
             if type(l).__name__ == "Dense"][-2:]
    adam_lr = 1e-5

    def groups():
        return {"head": (Adam(lr=adam_lr), heads),
                "rest": (SGD(1e-3, momentum=0.9), "*")}
    zero_dropout(model.model)
    dtypes.set_policy(compute_dtype="float32")
    try:
        ends = {}
        for where in ("card", "cpu"):
            with (zoo_device("cpu") if where == "cpu"
                  else contextlib.nullcontext()):
                target = torch.device("cpu") if where == "cpu" else dev
                model.set_variables(to_device(start, target))
                est = Estimator(model.model, optim_methods=groups())
                kernels.reset_launch_counts()
                est.train(FeatureSet.from_ndarrays(
                    x[:GROUP_ROWS], y[:GROUP_ROWS], shuffle=False),
                    "sparse_categorical_crossentropy_with_logits",
                    end_trigger=MaxEpoch(1), batch_size=GROUP_ROWS)
                ends[where] = (to_device(est.variables["params"],
                                         torch.device("cpu")),
                               kernels.launch_counts())
                if where == "card":
                    grouped = DistributedTrainer(model.model, None,
                                                 optim_groups=groups())
                    if grouped.fused_optimizer_active:
                        fail("optimizer groups ran the fused update")
    finally:
        dtypes.restore_policy(None)
    (pc, lc), (pp, _) = ends["card"], ends["cpu"]
    if lc["fused_adam"] or lc["fused_sgd"]:
        fail(f"grouped step launched an optimizer kernel: {lc}")
    tol = 2 * adam_lr + 1e-6
    diffs = {k: max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(pc[k]), tree_leaves(pp[k])))
             for k in pc if tree_leaves(pc[k])}
    moved = sum(not torch.equal(a, b) for k in pc for a, b in zip(
        tree_leaves(pc[k]), tree_leaves(to_device(start["params"][k],
                                                  torch.device("cpu")))))
    print(f"18d optimizer groups (Adam lr {adam_lr} on {heads}, "
          f"SGD(1e-3, momentum 0.9) on the rest), one step of "
          f"{GROUP_ROWS} x 512, float32 products, no dropout: launches "
          f"{lc}, {moved} leaves moved; card vs CPU max abs diff "
          f"{max(diffs.values()):.3e} (tolerance {tol:.1e}: an Adam "
          f"element whose gradient is float32 noise moves by up to its lr "
          f"either way), worst layer {max(diffs, key=diffs.get)}")
    if not max(diffs.values()) <= tol or not moved:
        fail(f"optimizer groups card vs CPU {diffs}")


def keras2_autograd_phase(torch, card, dev):
    """18e: a keras2 MNIST-style Sequential on the datasets' synthetic
    digits, and custom_loss_example.py's CustomLoss (checks only)."""
    from analytics_zoo_torch.pipeline.api import autograd as A
    from analytics_zoo_torch.pipeline.api import keras2
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.datasets import mnist
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    (xtr, ytr), (xte, yte) = mnist.load_data()
    xtr = (xtr[..., None] / 255.0).astype(np.float32)
    xte = (xte[..., None] / 255.0).astype(np.float32)
    Layer.reset_name_counters()
    net = keras2.Sequential()
    net.add(keras2.Conv2D(16, 3, activation="relu",
                          input_shape=(28, 28, 1)))
    net.add(keras2.MaxPooling2D())
    net.add(keras2.Flatten())
    net.add(keras2.Dense(10))
    net.init(torch.Generator().manual_seed(0))
    net.compile(Adam(lr=1e-3), "sparse_categorical_crossentropy_with_logits",
                metrics=["accuracy"])
    t0 = time.perf_counter()
    hist = net.fit(xtr, ytr.astype(np.int64), batch_size=128, epochs=2,
                   rng=0)
    fit_s = time.perf_counter() - t0
    acc = net.evaluate(xte, yte.astype(np.int64), batch_size=250)
    print(f"18e keras2 Conv2D -> MaxPooling2D -> Dense on "
          f"datasets.mnist's {len(xtr)} synthetic digits: 2 epochs in "
          f"{fit_s:.3f} s, losses {[h['loss'] for h in hist]}, test "
          f"{acc} ({card})")
    if not acc["sparse_categorical_accuracy"] > 0.2:
        fail(f"keras2 MNIST accuracy {acc} is not above chance")

    def custom_loss(y_true, y_pred):
        err = A.abs(y_true - y_pred)
        return A.mean(A.minimum(A.square(err), err), axis=1)
    rs = np.random.RandomState(0)
    x = rs.randn(512, 4).astype(np.float32)
    yv = (x @ rs.randn(4, 1)).astype(np.float32)
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(8, activation="relu", input_shape=(4,)))
    m.add(Dense(1))
    m.compile(Adam(lr=0.02), A.CustomLoss(custom_loss, y_pred_shape=(1,)))
    h = m.fit(x, yv, batch_size=64, nb_epoch=5, rng=0)
    print(f"18e autograd.CustomLoss (custom_loss_example.py's) fit 5 "
          f"epochs: losses {[round(v['loss'], 6) for v in h]}")
    if not h[-1]["loss"] < h[0]["loss"]:
        fail(f"CustomLoss fit {h}")


def text_matching_phase(torch, card, dev):
    """Phase 18: KNRM, MoE, ConvLSTM, the training switches, keras2 and
    autograd.  Returns the fused Adam launches of 18a and 18b."""
    from analytics_zoo_torch.ops import dtypes
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn(torch, card, dev)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out
    dtypes.set_policy(compute_dtype="float32")
    try:
        knrm = timed("18a", knrm_phase)
        moe = timed("18b", moe_phase)
        timed("18c", convlstm_phase)
    finally:
        dtypes.restore_policy(None)
    timed("18d", switches_phase)
    timed("18e", keras2_autograd_phase)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s ({seconds})")
    return knrm, moe


# ------------------------------------------- phase 19: compile and warm start
# 19e: what the cache holds and where the warm child builds
WARM_CHILD = "--warm-start-child"


def capture_count(since: int):
    """(captures, fallbacks) logged by the engine since ``since``."""
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    new = [c for c in CAPTURE_LOG[since:] if not c.get("eager")]
    return ([c for c in new if c["fallback"] is None],
            [c for c in new if c["fallback"] is not None])


def report_captures(tag: str, since: int, card: str,
                    allow_fallback: bool = True) -> None:
    """Print the programs captured since ``since`` (signatures, capture
    seconds, pool bytes) and every capture fallback; fail on a fallback
    where none is allowed."""
    import gc
    gc.collect()                  # graphs held in reference cycles, and
    import torch                  # their pools, go with the phase
    torch.cuda.empty_cache()
    caps, falls = capture_count(since)
    by_fn = Counter(c["fn"] for c in caps)
    secs = sum(c["capture_s"] for c in caps)
    pool = sum(max(c["pool_bytes"], 0) for c in caps)
    again = sum(1 for c in caps if c.get("recapture"))
    print(f"{tag}: {len(caps)} captured signatures {dict(by_fn)} ({again} "
          f"of them captured again for new weights), capture {secs:.3f} s, "
          f"pool bytes {pool} ({card})")
    for c in falls:
        print(f"{tag}: capture fallback {c['fn']}: {c['fallback']}")
    if falls and not allow_fallback:
        fail(f"{tag}: {len(falls)} capture fallback(s)")


def warm_start_child(build_dir: str, cache_dir: str) -> None:
    """Phase 19e's child: load every kernel library into an empty
    ``build_dir`` from the cache ``cache_dir``, counting every nvcc
    process it starts (``--version`` included); prints one JSON line."""
    os.environ["ZOO_TPU_COMPILE_CACHE"] = cache_dir
    from analytics_zoo_torch.observability import get_registry
    from analytics_zoo_torch.ops import kernels
    kernels.BUILD_DIR = build_dir
    real = subprocess.Popen
    calls = []

    class Counted(real):
        def __init__(self, args, *rest, **kw):
            if os.path.basename(str(args[0])) == "nvcc":
                calls.append(list(args[1:]))
            super().__init__(args, *rest, **kw)
    subprocess.Popen = Counted
    t0 = time.perf_counter()
    kernels.build_all()
    load_s = time.perf_counter() - t0
    reg = get_registry()
    hits = reg.counter("compile_cache_hits_total", labels=("fn",))
    corrupt = reg.counter("compile_cache_errors_total",
                          labels=("kind",)).labels("corrupt").value
    print(json.dumps({
        "load_s": load_s, "nvcc_calls": len(calls), "nvcc_args": calls,
        "hits": sum(hits.labels(s).value for s in kernels.SOURCES),
        "corrupt": corrupt, "loaded": sorted(kernels._libs)}))


def library_bytes(build_dir: str):
    return {f.rsplit("_", 1)[0]: open(os.path.join(build_dir, f), "rb").read()
            for f in sorted(os.listdir(build_dir)) if f.endswith(".so")}


def library_sass(build_dir: str):
    """Each library's kernels as ``cuobjdump --dump-sass`` prints them: two
    nvcc runs of one source write other bytes around the same machine
    code."""
    from analytics_zoo_torch.ops import kernels
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = {}
    for f in sorted(os.listdir(build_dir)):
        if f.endswith(".so"):
            out[f.rsplit("_", 1)[0]] = subprocess.run(
                [tool, "--dump-sass", os.path.join(build_dir, f)],
                capture_output=True, text=True, check=True).stdout
    return out


def warm_start_phase(card: str) -> None:
    """19e: a cold build fills a cache directory; a child process with an
    empty build directory loads every kernel from it without nvcc; then a
    corrupted entry is a loud miss, rebuilt, the same library bytes."""
    import shutil
    import tempfile

    from analytics_zoo_torch.compile.cache import reset_cache_state
    from analytics_zoo_torch.ops import kernels
    tmp = tempfile.mkdtemp(prefix="zoo-warm-start-")
    cache_dir = os.path.join(tmp, "cache")
    try:
        prev_dir = kernels.BUILD_DIR
        os.environ["ZOO_TPU_COMPILE_CACHE"] = cache_dir
        reset_cache_state()
        kernels.BUILD_DIR = os.path.join(tmp, "cold")
        t0 = time.perf_counter()
        kernels.build_libraries(kernels.SOURCES)
        cold_s = time.perf_counter() - t0
        kernels.BUILD_DIR = prev_dir
        del os.environ["ZOO_TPU_COMPILE_CACHE"]
        reset_cache_state()
        cold = library_bytes(os.path.join(tmp, "cold"))
        entries = sorted(f for f in os.listdir(cache_dir)
                         if f.endswith(".zooexec"))
        if len(entries) != len(kernels.SOURCES):
            fail(f"19e: the cold build stored {len(entries)} entries, want "
                 f"{len(kernels.SOURCES)}")

        def child(build):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), WARM_CHILD,
                 os.path.join(tmp, build), cache_dir],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"19e child ({build}) failed:\n{proc.stdout[-2000:]}"
                     f"\n{proc.stderr[-3000:]}")
            return json.loads(proc.stdout.strip().splitlines()[-1])
        warm = child("warm")
        if warm["nvcc_calls"] or warm["hits"] != len(kernels.SOURCES) or \
                len(warm["loaded"]) != len(kernels.SOURCES) or \
                library_bytes(os.path.join(tmp, "warm")) != cold:
            fail(f"19e: the warm child {warm}")
        print(f"warm start (19e): cold build of {len(kernels.SOURCES)} "
              f"kernel libraries (one nvcc each, all started together) "
              f"{cold_s:.3f} s; a second process loaded all "
              f"{len(warm['loaded'])} from the cache in {warm['load_s']:.3f} "
              f"s with {warm['nvcc_calls']} nvcc calls, {int(warm['hits'])} "
              f"hits, "
              f"the libraries bit-identical ({card})")
        # a flipped byte inside one entry's payload
        victim = os.path.join(cache_dir, entries[0])
        blob = bytearray(open(victim, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(blob))
        again = child("again")
        rebuilt = library_bytes(os.path.join(tmp, "again"))
        same_bytes = [k for k in cold if rebuilt.get(k) == cold[k]]
        if again["corrupt"] != 1 or again["nvcc_calls"] != 1 or \
                len(same_bytes) != len(cold) - 1 or \
                library_sass(os.path.join(tmp, "again")) != \
                library_sass(os.path.join(tmp, "cold")):
            fail(f"19e: after a corrupted entry {again}, {len(same_bytes)} "
                 f"of {len(cold)} libraries byte-identical")
        print(f"warm start (19e): a corrupted entry was a loud miss "
              f"(compile_cache_errors_total{{kind=\"corrupt\"}} "
              f"{int(again['corrupt'])}), rebuilt by {again['nvcc_calls']} "
              f"nvcc call in {again['load_s']:.3f} s; the other "
              f"{len(same_bytes)} libraries byte-identical from the cache, "
              f"the rebuilt one's kernels identical in SASS to the cold "
              f"build's (cuobjdump --dump-sass; nvcc writes other bytes "
              f"around them)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compile_phase(torch, card, dev) -> None:
    """Phase 19: the compiled path against the eager one (see the module
    docstring)."""
    import gc
    import itertools

    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.feature.datasets import movielens
    from analytics_zoo_torch.models.recommendation import NeuralCF
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.serving.engine import Request, ServingEngine
    cfg = get_config()
    t_phase = time.perf_counter()
    loss_name = "sparse_categorical_crossentropy_with_logits"

    def routes(fn, order=(True, False, False, True)):
        """``fn(aot)`` in turns, compile.aot set for each; {aot: [out]}."""
        out = {True: [], False: []}
        for aot in order:
            cfg.set("compile.aot", aot)
            out[aot].append(fn(aot))
        cfg.set("compile.aot", True)
        return out

    def spread(v):
        return f"median {statistics.median(v):.3f} ms, spread " \
               f"{min(v):.3f}-{max(v):.3f}"

    # ---- 19a. BERT-base fit, captured and eager, deterministic
    rs = np.random.RandomState(19)
    x = rs.randint(0, 30522, size=(64, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(64,)).astype(np.int64)
    mark = len(CAPTURE_LOG)

    def bert_fit(aot):
        Layer.reset_name_counters()
        model = bert_base()
        model.model.init(torch.Generator().manual_seed(0))
        model.compile(Adam(lr=1e-4), loss_name)
        kernels.reset_launch_counts()
        with deterministic(torch):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            hist = model.fit(x, y, batch_size=8, nb_epoch=1, rng=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        leaves = [t.clone() for t in
                  tree_leaves(model.get_variables()["params"])]
        return [h["loss"] for h in hist], kernels.launch_counts(), leaves, \
            wall, model
    cfg.set("compile.aot", True)
    h_aot, l_aot, p_aot, w_aot, model = bert_fit(True)
    report_captures("19a BERT-base fit captured", mark, card,
                    allow_fallback=False)
    cfg.set("compile.aot", False)
    h_eag, l_eag, p_eag, w_eag, _ = bert_fit(False)
    cfg.set("compile.aot", True)
    want = {name: 0 for name in kernels.SIGNATURES}
    want.update({"flash_attention_fwd": 96, "flash_attention_dq": 96,
                 "flash_attention_dkv": 96, "bias_gelu": 96,
                 "layernorm_act": 8, "fused_adam": 8})
    if l_aot != want or l_eag != want:
        fail(f"19a launches captured {l_aot}, eager {l_eag}, want {want}")
    same = h_aot == h_eag and all(torch.equal(a, b)
                                  for a, b in zip(p_aot, p_eag))
    if not same:
        worst = max(float((a - b).abs().max()) for a, b in zip(p_aot, p_eag))
        fail(f"19a captured vs eager fit: history {h_aot} vs {h_eag}, "
             f"params max abs diff {worst:.3e}")
    print(f"19a BERT-base fit (64 x 512, batch 8, Adam, dropout on, "
          f"deterministic): captured and eager bit-identical, history "
          f"{h_aot}, all {len(p_aot)} leaves; launches a step 12/12/12/12/"
          f"1/1 on both; fit wall {w_aot:.3f} s captured (capture "
          f"included), {w_eag:.3f} s eager ({card})")
    del p_aot, p_eag
    loss_fn = objectives.get(loss_name)
    batch_np = (x[:8], y[:8])
    params0 = model.get_variables()["params"]

    def bert_steps(aot, n=6):
        tr = DistributedTrainer(model.model, loss_fn,
                                optim_method=Adam(lr=1e-4))
        params = tr.place_params(params0)
        opt_state, state = tr.init_opt_state(params), {}
        batch = tr.put_batch(batch_np)
        ms = []
        with deterministic(torch):
            for i in range(n + 1):            # the first captures
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                params, opt_state, state, _ = tr.train_step_at(
                    params, opt_state, state, batch, 0, i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - s0) * 1e3)
        return ms[1:]
    mark = len(CAPTURE_LOG)
    steps = routes(bert_steps)
    caps, falls = capture_count(mark)
    if falls:
        fail(f"19a step capture fallback {falls}")
    step_caps = [c for c in caps if c["fn"] == "train_step_at"]
    for aot, name in ((True, "captured"), (False, "eager")):
        v = sum(steps[aot], [])
        print(f"19a BERT-base train_step_at {name}: {spread(v)} over "
              f"{len(v)} steps in 2 turns, batch 8 x 512, Adam ({card})")
    print(f"19a capture: {[round(c['capture_s'], 3) for c in step_caps]} s "
          f"a turn, pool bytes {[c['pool_bytes'] for c in step_caps]} "
          f"({card})")
    del model, params0
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19b. BERT-base served through InferenceModel
    Layer.reset_name_counters()
    serve = bert_base()
    serve.model.init(torch.Generator().manual_seed(0))
    reqs = [rs.randint(0, 30522, size=(8, 512)).astype(np.int64)
            for _ in range(4)]
    mark = len(CAPTURE_LOG)
    im = InferenceModel().load_zoo(serve)
    t0 = time.perf_counter()
    for b in (1, 2, 4, 8):
        im.warm((512,), b, dtype=np.int64)
    warm_s = time.perf_counter() - t0
    if im.aot_signatures != 4:
        fail(f"19b warm captured {im.aot_signatures} buckets, want 4")
    report_captures("19b InferenceModel.warm", mark, card,
                    allow_fallback=False)

    def serve_once(aot):
        kernels.reset_launch_counts()
        outs, ms = [], []
        for r in reqs:
            s0 = time.perf_counter()
            outs.append(im.predict(r, batch_size=8))
            ms.append((time.perf_counter() - s0) * 1e3)
        return outs, ms, kernels.launch_counts()
    im.predict(reqs[0], batch_size=8)          # the eager route's set-up
    served = routes(serve_once)
    for a, b in zip(served[True][0][0], served[False][0][0]):
        if not np.array_equal(a, b):
            fail("19b captured and eager logits differ")
    if served[True][0][2] != served[False][0][2]:
        fail(f"19b launches {served[True][0][2]} vs {served[False][0][2]}")
    for aot, name in ((True, "captured"), (False, "eager")):
        v = sum((r[1] for r in served[aot]), [])
        print(f"19b BERT-base request {name} (8 x 512): {spread(v)} over "
              f"{len(v)} requests in 2 turns ({card})")
    print(f"19b: warm captured buckets 1/2/4/8 x 512 in {warm_s:.3f} s; "
          f"logits captured vs eager bit-identical; launches a request "
          f"{served[True][0][2]} on both")
    fronts = {}
    for aot in (True, False):
        cfg.set("compile.aot", aot)
        run = serve_front_end(torch, im, fail)
        fronts[aot] = run
        n = len(run["results"])
        print(f"19b cluster serving {'captured' if aot else 'eager'}: "
              f"{n} records in {run['wall_s']:.4f} s, "
              f"{n / run['wall_s']:.2f} records/s, arrival->result p50 "
              f"{run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms "
              f"({card})")
    cfg.set("compile.aot", True)
    # the batches' compositions follow arrival timing, and a bucket's size
    # picks the products' kernels, so a record's probabilities may move in
    # their last bits between the runs: top-1 and PROB_ATOL
    worst = 0.0
    for a, b in zip(fronts[True]["results"], fronts[False]["results"]):
        pa, pb = dict(a), dict(b)
        worst = max([worst] + [abs(pa[k] - pb[k]) for k in pa if k in pb])
        if a[0][0] != b[0][0] and abs(a[0][1] - a[1][1]) > PROB_ATOL:
            fail(f"19b cluster serving: top-1 {a} captured, {b} eager")
    if not worst <= PROB_ATOL:
        fail(f"19b cluster serving: probabilities captured vs eager differ "
             f"by {worst}")
    print(f"19b cluster serving captured vs eager: top-1 equal, "
          f"probabilities max abs diff {worst:.3e} (tolerance {PROB_ATOL})")
    del im, serve, served, fronts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19c. NeuralCF's routes at bench_ncf's width
    users, items = movielens.ML1M_USERS, movielens.ML1M_ITEMS
    ratings = movielens.synthetic_ratings(users, items, 1_000_000)
    train_x, train_y, _, _ = movielens.build_ncf_samples(
        ratings, users, items, neg_per_pos=4, eval_neg=100)
    batch = NCF_BATCH
    nb = len(train_y) // batch
    ncf_routes = {"hbm": (16, 2048, True), "chunked": (16, 0, True),
                  "per_step_captured": (1, 2048, True),
                  "per_step_eager": (1, 2048, False)}
    moved = []
    # the trainer's two host-to-device entries: put_batch (a step's rows)
    # and put_whole (the HBM epoch's rows and the chunks, every row)
    real_puts = {"put_batch": DistributedTrainer.put_batch,
                 "put_whole": DistributedTrainer.put_whole}

    def counting(real):
        def put(self, b):
            moved.append(sum(int(np.asarray(a).nbytes)
                             for a in tree_leaves(b) if a is not None and
                             not isinstance(a, torch.Tensor)))
            return real(self, b)
        return put

    def ncf_fit(route):
        k, mb, aot = ncf_routes[route]
        cfg.set("train.steps_per_dispatch", k)
        cfg.set("train.hbm_cache_mb", mb)
        cfg.set("compile.aot", aot)
        Layer.reset_name_counters()
        m = NeuralCF(users, items, class_num=2, user_embed=64, item_embed=64,
                     mf_embed=64, hidden_layers=(128, 64, 32))
        m.model.init(torch.Generator().manual_seed(0))
        m.compile(Adam(lr=1e-3), loss_name)
        moved.clear()
        for name, real in real_puts.items():
            setattr(DistributedTrainer, name, counting(real))
        try:
            with deterministic(torch):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                hist = m.fit(train_x, train_y, batch_size=batch, nb_epoch=2,
                             rng=0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
        finally:
            for name, real in real_puts.items():
                setattr(DistributedTrainer, name, real)
        leaves = [t.clone() for t in tree_leaves(m.get_variables()["params"])]
        return dict(hist=[h["loss"] for h in hist], leaves=leaves, wall=wall,
                    epoch_s=[h["wall_s"] for h in hist], moved=list(moved))
    mark = len(CAPTURE_LOG)
    ncf = {}
    for route in ("hbm", "chunked", "per_step_captured", "per_step_eager",
                  "per_step_captured", "chunked", "hbm"):
        ncf.setdefault(route, []).append(ncf_fit(route))
    cfg.set("train.steps_per_dispatch", 16)
    cfg.set("train.hbm_cache_mb", 2048)
    cfg.set("compile.aot", True)
    report_captures("19c NeuralCF fits", mark, card, allow_fallback=False)
    ref = ncf["per_step_eager"][0]["leaves"]
    for route, runs in ncf.items():
        for run in runs:
            if not all(torch.equal(a, b) for a, b in zip(run["leaves"], ref)):
                fail(f"19c {route}: params differ from the per-step route")
    # the step losses of the per-step route, for the routes' rules
    cfg.set("compile.aot", False)
    Layer.reset_name_counters()
    m = NeuralCF(users, items, class_num=2, user_embed=64, item_embed=64,
                 mf_embed=64, hidden_layers=(128, 64, 32))
    m.model.init(torch.Generator().manual_seed(0))
    tr = DistributedTrainer(m.model, objectives.get(loss_name),
                            optim_method=Adam(lr=1e-3))
    params = tr.place_params(m.get_variables()["params"])
    opt_state, state = tr.init_opt_state(params), {}
    fs = FeatureSet.from_ndarrays(train_x, train_y)
    step_losses = []
    with deterministic(torch):
        for epoch in range(2):
            for i, b in enumerate(fs.epoch_batches(epoch, batch)):
                params, opt_state, state, loss = tr.train_step_at(
                    params, opt_state, state, tr.put_batch(b), 0,
                    epoch * nb + i)
                step_losses.append(loss)
    cfg.set("compile.aot", True)
    last = step_losses[nb:]
    rules = {"per_step_eager": float(last[-1]),
             "per_step_captured": float(last[-1]),
             "chunked": float(torch.stack(last[(nb - 1) // 16 * 16:]).mean()),
             "hbm": float(torch.stack(last).mean())}
    for route, want_loss in rules.items():
        got = ncf[route][0]["hist"][1]
        if abs(got - want_loss) > 1e-6 * max(1.0, abs(want_loss)):
            fail(f"19c {route}: epoch-2 loss {got} against its rule "
                 f"{want_loss}")
    full = sum(int(a.nbytes) for a in list(train_x) + [train_y])
    for route, runs in ncf.items():
        ms = [r["epoch_s"][1] * 1e3 / nb for r in runs]
        print(f"19c NeuralCF {route}: second epoch {ms} ms a step, "
              f"{[round(batch * 1e3 / v, 1) for v in ms]} samples/s, "
              f"history {runs[0]['hist']}; put_batch/put_whole moved "
              f"{sum(runs[0]['moved'])} bytes in {len(runs[0]['moved'])} "
              f"calls over 2 epochs ({card})")
    hbm_moved = ncf["hbm"][0]["moved"]
    if hbm_moved != [full]:
        fail(f"19c hbm: put_batch/put_whole moved {hbm_moved}, want the "
             f"dataset once "
             f"({full} bytes) and nothing within an epoch")
    print(f"19c: the routes' params bit-identical (deterministic "
          f"algorithms), each epoch-2 loss its route's rule; the HBM route "
          f"placed the dataset once ({full} bytes) and copied nothing from "
          f"the host within an epoch but its int64 permutation")
    del ncf, m, tr, params, opt_state, step_losses
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19d. generative serving, the decode pool captured at every rung
    sm, enc, budgets = seq2seq_model(torch)
    kw = dict(start_sign=GEN_START, max_seq_len=GEN_MAX_LEN,
              stop_sign=GEN_STOP)
    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    rows, margins = greedy_margins(torch, sm, enc, GEN_START, GEN_MAX_LEN)
    served = {}
    for aot in (True, False, False, True):
        cfg.set("compile.aot", aot)
        mark = len(CAPTURE_LOG)
        if not np.array_equal(sm.infer(enc, start_sign=GEN_START,
                                       max_seq_len=GEN_MAX_LEN), rows):
            fail(f"19d: infer ({'captured' if aot else 'eager'}) and the "
                 "margin walk disagree")
        eng_ = ServingEngine()
        ep = eng_.register_generative(
            "gen", sm, enc_len=GEN_ENC_LEN, stop_sign=GEN_STOP,
            start_sign=GEN_START, max_seq_len=GEN_MAX_LEN, slots=GEN_SLOTS)
        ep.warm()
        rungs = 2 * len(ep.pool.buckets)
        captured = ep.pool._step.aot_signatures + \
            ep.pool._prefill.aot_signatures
        if captured != (rungs if aot else 0):
            fail(f"19d: {captured} captured rungs of {rungs}")
        eng_.start()
        times = {i: [] for i in range(GEN_REQUESTS)}
        t0 = time.perf_counter()
        rq = [Request(endpoint="gen", uri=f"c{i}", data=enc[i],
                      max_tokens=int(budgets[i]),
                      on_token=(lambda i: lambda _j, _t: times[i].append(
                          time.perf_counter()))(i))
              for i in range(GEN_REQUESTS)]
        eng_.wait_all(eng_.submit(rq), timeout_s=600)
        wall = time.perf_counter() - t0
        eng_.stop()
        if any(r.error is not None for r in rq):
            fail("19d: a generative request failed")
        compared = sum(held_to_infer(
            f"19d {'captured' if aot else 'eager'} request {i}", r.result,
            rows[i], margins[i], budgets[i]) for i, r in enumerate(rq))
        gaps = []
        for i in range(GEN_REQUESTS):
            gaps.extend(np.diff(times[i]).tolist())
        tokens = sum(len(r.result) for r in rq)
        served.setdefault(aot, []).append(
            (tokens / wall, float(np.percentile(gaps, 50)) * 1e3,
             float(np.percentile(gaps, 99)) * 1e3, [r.result for r in rq],
             compared))
        if aot:
            report_captures("19d decode pool and infer", mark, card,
                            allow_fallback=False)
    cfg.set("compile.aot", True)
    dtypes.restore_policy(default)
    same = sum(a == b for a, b in zip(served[True][0][3],
                                      served[False][0][3]))
    for aot, name in ((True, "captured"), (False, "eager")):
        runs = served[aot]
        print(f"19d generative {name} (64 requests, 16 slots, float32 "
              f"products): {[round(r[0], 1) for r in runs]} tokens/s, "
              f"inter-token p50 {[round(r[1], 3) for r in runs]} ms, p99 "
              f"{[round(r[2], 3) for r in runs]} ms ({card})")
    print(f"19d: served tokens held to Seq2seq.infer's rows on both routes "
          f"({served[True][0][4]} of them up to each row's first margin "
          f"below {GEN_MARGIN}); captured and eager pools served the same "
          f"tokens on {same} of {GEN_REQUESTS} requests; every rung "
          f"captured")
    del sm, served
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19e. warm start across processes
    warm_start_phase(card)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s ({card})")


# ------------------------------------------------------------------ phase 20
PIPE_ROWS, PIPE_BATCH, PIPE_EPOCHS, PIPE_EVERY = 256, 8, 2, 12
PIPE_FAULT_STEP = 20              # the first epoch's 21st batch
INPUT_ROWS, INPUT_BATCH, INPUT_HW = 4096, 128, 32   # bench_input_pipeline
CRC_BYTES = 1 << 21
SCORE_ROWS, SCORE_SHARD, SCORE_BATCH, SCORE_WORKERS = 4096, 512, 128, 2
FLEET_ROWS, FLEET_SHARD, FLEET_BATCH, FLEET_WORKERS = 2048, 256, 32, 2
FLEET_LEASE_S = 5.0
STARTUP_FILE = "startup-{pid}.json"


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class FleetModel:
    """Phase 20d's model in a fleet worker: the ``InferenceModel`` of
    ``fleet_bert``; ``warm`` fails unless it captured on the card, and
    writes the incarnation's start-up record (seconds since the process
    started, nvcc processes it started, captured buckets) into its
    run-dir slot."""

    def __init__(self, im, nvcc_calls):
        self.im = im
        self.nvcc_calls = nvcc_calls

    def predict(self, x, batch_size=None):
        return self.im.predict(x, batch_size=batch_size)

    def warm(self, input_shape, batch_size, dtype=np.float32):
        if self.im.device.type != "cuda":
            raise RuntimeError(f"fleet worker on {self.im.device}, not a GPU")
        self.im.warm(input_shape, batch_size, dtype=dtype)
        if self.im.aot_signatures < 1:
            raise RuntimeError("warm did not capture the predict program")
        slot = os.environ.get("ZOO_TPU_METRICS_DIR")
        if slot:
            with open(os.path.join(slot, STARTUP_FILE.format(
                    pid=os.getpid())), "w") as f:
                json.dump({"pid": os.getpid(), "written": time.time(),
                           "startup_s": _process_age_s(),
                           "nvcc_calls": len(self.nvcc_calls),
                           "captured": self.im.aot_signatures}, f)
        return True


def fleet_bert(weights: str, device: str = "cuda:0", fresh_build: bool = True):
    """Phase 20d's builder (``/path/chip_smoke.py:fleet_bert``): phase 3's
    ``TextClassifier`` with the weights of ``save_model`` file
    ``weights``, behind ``InferenceModel`` on ``device``.  With
    ``fresh_build`` (a fleet worker) the kernel libraries go to an empty
    build directory of this process, so they come from the run dir's
    compile farm or from nvcc, whose processes are counted."""
    import tempfile

    import torch

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    calls = []
    if fresh_build:
        kernels.BUILD_DIR = tempfile.mkdtemp(prefix="zoo-fleet-build-")
        real = subprocess.Popen

        class Counted(real):
            def __init__(self, args, *rest, **kw):
                if os.path.basename(str(args[0])) == "nvcc":
                    calls.append(list(args[1:]))
                super().__init__(args, *rest, **kw)
        subprocess.Popen = Counted
    ctx = init_zoo_context(device=device)
    if ctx.device.type != "cuda":
        raise RuntimeError(f"fleet builder on {ctx.device}, not a GPU")
    Layer.reset_name_counters()
    model = bert_base()
    model.model.init(torch.Generator().manual_seed(0))
    im = InferenceModel().load_zoo_file(model, weights)
    return FleetModel(im, calls)


def input_pipeline_bench(torch, dev) -> dict:
    """``bench_input_pipeline`` (``bench.py:1148-1237``) at its defaults on
    the port: samples/s of bare iteration, a normalize stage
    single-threaded and in a pool of 4, and the ``DeviceLoader`` path
    (depth 2, 2 workers) to a batch resident on the card, each batch
    synchronized before the next is pulled."""
    from analytics_zoo_torch.data import DataPipeline, DeviceLoader
    rs = np.random.RandomState(0)
    x = (rs.rand(INPUT_ROWS, INPUT_HW, INPUT_HW, 3) * 255).astype(np.float32)
    y = rs.randint(0, 1000, size=(INPUT_ROWS, 1)).astype(np.int32)
    mean, std = x.mean(), x.std() + 1e-6

    def normalize(batch):
        bx, by = batch
        return ((bx - mean) / std, by)

    def time_epochs(pipe, epochs=3):
        for _ in pipe:             # epoch 0 warms pools and caches
            pass
        t0 = time.perf_counter()
        n = 0
        for _ in range(epochs):
            for _ in pipe:
                n += 1
        wall = time.perf_counter() - t0
        pipe.close()
        return n * pipe.batch_size / wall

    out = {
        "bare": time_epochs(DataPipeline(x, y, batch_size=INPUT_BATCH,
                                         seed=7, name="bench-base")),
        "map": time_epochs(DataPipeline(x, y, batch_size=INPUT_BATCH,
                                        seed=7, name="bench-map")
                           .map(normalize)),
        "pooled_map": time_epochs(DataPipeline(
            x, y, batch_size=INPUT_BATCH, seed=7, num_workers=4,
            name="bench-pool").map(normalize))}
    pipe = DataPipeline(x, y, batch_size=INPUT_BATCH, seed=7, num_workers=2,
                        name="bench-device").map(normalize)
    loader = DeviceLoader(pipe, depth=2)
    for b in loader:                # warm epoch
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(2):
        for b in loader:
            if b[0].device != dev:
                fail(f"20b: a DeviceLoader batch on {b[0].device}")
            torch.cuda.synchronize()
            n += 1
    out["device_feed"] = n * INPUT_BATCH / (time.perf_counter() - t0)
    pipe.close()
    out["sample_bytes"] = int(x[0].nbytes + y[0].nbytes)
    # the TFRecord framing's CRC-32C (the port's table loop) on the host
    from analytics_zoo_torch.utils.crc32c import crc32c
    blob = rs.bytes(CRC_BYTES)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        crc32c(blob)
        runs.append(CRC_BYTES / 1e6 / (time.perf_counter() - t0))
    out["crc32c_mb_s"] = runs
    return out


def fleet_env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def startup_records(run_dir: str):
    out = []
    for slot in sorted(os.listdir(run_dir)):
        path = os.path.join(run_dir, slot)
        if slot.startswith("host-") and os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.startswith("startup-"):
                    with open(os.path.join(path, name)) as f:
                        out.append(dict(json.load(f), slot=slot))
    return out


def outputs(out_dir: str, shards: int) -> np.ndarray:
    return np.concatenate([np.load(os.path.join(
        out_dir, f"shard-{i:05d}.npy")) for i in range(shards)])


def pipeline_training(torch, card, dev, tmp) -> None:
    """20a: phase 4's BERT-base trained on a ``DataPipeline`` over an
    ``NpyDirSource``, stopped by a fault at ``data.batch`` and resumed,
    against the uninterrupted run; then the pipeline route's step time in
    turns with the ``FeatureSet`` per-step route."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.common.triggers import (
        MaxEpoch, SeveralIteration)
    from analytics_zoo_torch.data import DataPipeline, NpyDirSource
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.observability import get_registry
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.estimator import Estimator
    from analytics_zoo_torch.resilience.chaos import (
        ChaosPlan, FaultSpec, TransientFault, clear_chaos, install_chaos)
    cfg = get_config()
    loss_name = "sparse_categorical_crossentropy_with_logits"
    rs = np.random.RandomState(20)
    data_dir = os.path.join(tmp, "npy")
    os.makedirs(data_dir)
    x = rs.randint(0, 30522, size=(PIPE_ROWS, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(PIPE_ROWS,)).astype(np.int64)
    np.save(os.path.join(data_dir, "x.npy"), x)
    np.save(os.path.join(data_dir, "y.npy"), y)
    steps = PIPE_EPOCHS * PIPE_ROWS // PIPE_BATCH

    def pipe():
        return DataPipeline(NpyDirSource(data_dir), batch_size=PIPE_BATCH,
                            shuffle=True, seed=20).workers(2)

    def run(model_dir=None, train_set=None):
        Layer.reset_name_counters()
        model = bert_base()
        model.model.init(torch.Generator().manual_seed(0))
        est = Estimator(model.model, optim_method=Adam(lr=1e-4),
                        model_dir=model_dir)
        train_set = train_set if train_set is not None else pipe()
        try:
            with deterministic(torch):
                est.train(train_set, loss_name,
                          end_trigger=MaxEpoch(PIPE_EPOCHS),
                          checkpoint_trigger=SeveralIteration(PIPE_EVERY),
                          rng=0)
        finally:
            train_set.close()
        return model, est.history

    kernels.reset_launch_counts()
    whole = run(os.path.join(tmp, "whole"))
    launches = kernels.launch_counts()
    expect_launches(launches, {
        "flash_attention_fwd": 12 * steps, "flash_attention_dq": 12 * steps,
        "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
        "layernorm_act": steps, "fused_adam": steps},
        "20a pipeline training")
    control = run()
    # the fault: data.batch trips at the first epoch's 21st batch, before
    # its position commits; no retry, so it stops the run
    retries = cfg.get("train.retry_times")
    cfg.set("train.retry_times", 0)
    install_chaos(ChaosPlan([FaultSpec("data.batch", at_step=PIPE_FAULT_STEP)]))
    stopped = os.path.join(tmp, "stopped")
    try:
        run(stopped)
    except TransientFault:
        pass
    else:
        fail("20a: the injected data.batch fault did not stop the run")
    finally:
        clear_chaos()
        cfg.set("train.retry_times", retries)
    snaps = sorted(os.listdir(stopped))
    # the resumed run's first batch: record the first device batch that
    # the DeviceLoader hands a real step after the restore (the warm
    # start's peek is placed by put_batch and never reaches a step)
    first = []
    real_step = DistributedTrainer.train_step_at

    def step_at(self, params, opt_state, state, batch, seed, step):
        if not first:
            first.append((step, [t.detach().cpu().numpy() for t in batch]))
        return real_step(self, params, opt_state, state, batch, seed, step)
    DistributedTrainer.train_step_at = step_at
    try:
        resumed_pipe = pipe()
        resumed = run(stopped, resumed_pipe)
    finally:
        DistributedTrainer.train_step_at = real_step
    want_first = next(iter(pipe().iter_epoch(0, PIPE_EVERY)))[1]
    first_step, first_batch = first[0]
    if first_step != PIPE_EVERY or not (
            np.array_equal(first_batch[0], want_first[0]) and
            np.array_equal(first_batch[1], want_first[1])):
        fail(f"20a: the resumed run's first step (iteration {first_step}) "
             "did not take the uninterrupted run's batch "
             f"{PIPE_EVERY + 1}")
    if (resumed_pipe.epoch, resumed_pipe.step) != (PIPE_EPOCHS, 0):
        fail(f"20a: resumed pipeline at {resumed_pipe.state_dict()}")
    print(f"20a pipeline training: BERT-base, {PIPE_ROWS} x 512 tokens from "
          f"an NpyDirSource, batch {PIPE_BATCH}, shuffled, 2 workers, Adam, "
          f"{PIPE_EPOCHS} epochs ({steps} steps), snapshots every "
          f"{PIPE_EVERY} iterations; launches {launches} (12/12/12/12/1/1 a "
          f"step); a data.batch fault at the first epoch's step "
          f"{PIPE_FAULT_STEP} stopped a run holding {snaps}; the resumed "
          f"run's first step (iteration {first_step}) took the device batch "
          f"equal to the epoch's batch {PIPE_EVERY + 1} ({card})")
    hold_resumed("20a resumed pipeline run", [h["loss"] for h in resumed[1]],
                 resumed[0], whole, control, card)
    snapshot_lines("20a", card)

    # step time in turns: the pipeline route against the FeatureSet's
    # per-step route, two epochs each, no snapshots; the second epoch's
    # wall (history's wall_s: after the first epoch's closing loss read,
    # so warm start and capture lie outside it) over its steps
    wait = get_registry().histogram("train_step_time_seconds",
                                     labels=("component",)).labels(
        "data_wait")
    ms = {"pipeline": [], "feature_set": []}
    waits = []
    per_dispatch = cfg.get("train.steps_per_dispatch")
    for route in ("pipeline", "feature_set", "feature_set", "pipeline"):
        Layer.reset_name_counters()
        model = bert_base()
        model.model.init(torch.Generator().manual_seed(0))
        est = Estimator(model.model, optim_method=Adam(lr=1e-4))
        if route == "pipeline":
            data = pipe()
            n0, s0 = wait.count, wait.sum
        else:
            cfg.set("train.steps_per_dispatch", 1)
            data = FeatureSet.from_ndarrays(x, y, seed=20)
        est.train(data, loss_name, end_trigger=MaxEpoch(2),
                  batch_size=PIPE_BATCH, rng=0)
        if route == "pipeline":
            data.close()
            waits.append((wait.sum - s0) / max(wait.count - n0, 1) * 1e3)
        else:
            cfg.set("train.steps_per_dispatch", per_dispatch)
        ms[route].append(est.history[1]["wall_s"] * 1e3
                         / (PIPE_ROWS // PIPE_BATCH))
    print(f"20a step ms (the second epoch's wall over its "
          f"{PIPE_ROWS // PIPE_BATCH} steps), in turns: pipeline "
          f"{[round(v, 3) for v in ms['pipeline']]}, FeatureSet per-step "
          f"{[round(v, 3) for v in ms['feature_set']]}; the host's wait "
          f"for a DeviceLoader batch, mean ms a step "
          f"{[round(v, 4) for v in waits]} ({card})")


def batch_scoring_bench(card, tmp) -> None:
    """20c: ``bench_batch_scoring`` (``bench.py:1239-1325``) at its
    defaults on the port: the demo job through a coordinator and 2 worker
    processes, a clean control and a drill in which chaos kills worker 0
    at ``worker.step`` 1."""
    from analytics_zoo_torch.batchjobs.coordinator import run_job
    from analytics_zoo_torch.batchjobs.demo import demo_job
    from analytics_zoo_torch.resilience.chaos import ChaosPlan, FaultSpec
    root = os.path.join(tmp, "bench-batch")
    control = run_job(
        demo_job(os.path.join(root, "out-control"), num_rows=SCORE_ROWS,
                 rows_per_shard=SCORE_SHARD, batch_size=SCORE_BATCH),
        os.path.join(root, "run-control"), num_workers=SCORE_WORKERS,
        env=fleet_env(), timeout_s=240)
    drill_rows = max(SCORE_ROWS // 4, SCORE_SHARD)
    drill_shard = max(SCORE_SHARD // 2, SCORE_BATCH)
    drill = run_job(
        demo_job(os.path.join(root, "out-drill"), num_rows=drill_rows,
                 rows_per_shard=drill_shard, batch_size=SCORE_BATCH,
                 delay_s=0.1, lease_timeout_s=1.5),
        os.path.join(root, "run-drill"), num_workers=SCORE_WORKERS,
        env=fleet_env(), timeout_s=240,
        chaos=ChaosPlan([FaultSpec(site="worker.step", at_step=1,
                                   kind="kill", process_index=0)]))
    res = drill["resume"]
    if control["status"] != "complete" or drill["status"] != "complete" or \
            drill["restarts"] < 1 or res["duplicate_commits"] != 0 or \
            not 0 < res["rows_recomputed"] < drill_shard:
        fail(f"20c: control {control}, drill {drill}")
    target = f"{control['target_deadline_s']:g}"
    print(f"20c batch scoring (the demo job, {SCORE_ROWS} rows, "
          f"{SCORE_SHARD} a shard, batch {SCORE_BATCH}, {SCORE_WORKERS} "
          f"workers, numpy LinearModel on the host): "
          f"{control['rows_per_sec_per_chip']} rows/s/chip, "
          f"{control['rows_per_sec']} rows/s, chips for the {target} s "
          f"deadline {control['chips_for'].get(target)}; drill "
          f"({drill_rows} rows, {drill_shard} a shard, worker 0 killed at "
          f"worker.step 1): resume overhead fraction "
          f"{res['resume_overhead_fraction']}, {res['rows_recomputed']} rows "
          f"recomputed, {drill['restarts']} restart(s), "
          f"{res['duplicate_commits']} duplicate commits ({card})")


def fleet_scoring(torch, card, dev, tmp) -> None:
    """20d: phase 3's BERT-base scoring 2048 rows of 512 tokens through
    the batch fleet (2 worker processes on the card), a control and a
    kill drill, held byte for byte to each other and to an in-process
    ``InferenceModel.predict``; one ``BatchWorker`` in process on a
    256-row ledger with its launches checked."""
    import shutil

    from analytics_zoo_torch.batchjobs import (
        BatchJobSpec, BatchWorker, ShardManifest)
    from analytics_zoo_torch.batchjobs.coordinator import run_job
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    from analytics_zoo_torch.data import NpyDirSource
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.resilience.chaos import ChaosPlan, FaultSpec
    rs = np.random.RandomState(21)
    data_dir = os.path.join(tmp, "fleet-npy")
    os.makedirs(data_dir)
    x = rs.randint(0, 30522, size=(FLEET_ROWS, 512)).astype(np.int64)
    np.save(os.path.join(data_dir, "x.npy"), x)
    Layer.reset_name_counters()
    model = bert_base()
    model.model.init(torch.Generator().manual_seed(3))
    weights = os.path.join(tmp, "bert-base.ckpt")
    model.save_model(weights)
    del model
    ref = f"{os.path.abspath(__file__)}:fleet_bert"
    shards = FLEET_ROWS // FLEET_SHARD

    def job(out, rows=FLEET_ROWS, data=data_dir):
        return BatchJobSpec(
            name="bert-base-scoring", output_dir=out,
            source={"kind": "npy_dir", "path": data},
            model={"kind": "builder", "ref": ref,
                   "args": {"weights": weights, "device": "cuda:0"}},
            rows_per_shard=FLEET_SHARD, batch_size=FLEET_BATCH,
            lease_timeout_s=FLEET_LEASE_S, num_rows=rows)

    ctl_run = os.path.join(tmp, "fleet-control")
    t0 = time.perf_counter()
    control = run_job(job(os.path.join(tmp, "fleet-out-control")), ctl_run,
                      num_workers=FLEET_WORKERS, env=fleet_env(),
                      timeout_s=600)
    ctl_wall = time.perf_counter() - t0
    drill_run = os.path.join(tmp, "fleet-drill")
    # the drill's run dir starts with the control's compile farm: the
    # kernel libraries process 0 stored there (none where no kernel was
    # built: the replacement's nvcc count then shows it)
    farm = os.path.join(ctl_run, "compile-cache")
    if os.path.isdir(farm):
        shutil.copytree(farm, os.path.join(drill_run, "compile-cache"))
    drill = run_job(
        job(os.path.join(tmp, "fleet-out-drill")), drill_run,
        num_workers=FLEET_WORKERS, env=fleet_env(), timeout_s=600,
        chaos=ChaosPlan([FaultSpec(site="worker.step", at_step=1,
                                   kind="kill", process_index=0)]))
    got_ctl = outputs(os.path.join(tmp, "fleet-out-control"), shards)
    got_drill = outputs(os.path.join(tmp, "fleet-out-drill"), shards)
    res = drill["resume"]
    if control["status"] != "complete" or drill["status"] != "complete" or \
            drill["restarts"] < 1 or res["duplicate_commits"] != 0 or \
            not 0 < res["rows_recomputed"] < FLEET_SHARD:
        fail(f"20d: control {control}, drill {drill}")
    if got_ctl.shape != (FLEET_ROWS, 20) or not np.isfinite(got_ctl).all():
        fail(f"20d: outputs {got_ctl.shape}, finite "
             f"{np.isfinite(got_ctl).all()}")
    if got_drill.tobytes() != got_ctl.tobytes():
        fail(f"20d: the drill's outputs differ from the control's by "
             f"{float(np.abs(got_drill - got_ctl).max())}")
    cold = startup_records(ctl_run)
    warm = startup_records(drill_run)
    replacement = [r for r in warm if r["slot"] == "host-0"]
    if len(cold) != FLEET_WORKERS or len(replacement) != 2 or \
            any(r["captured"] < 1 for r in cold + warm):
        fail(f"20d: start-up records {cold} {warm}")
    replacement = max(replacement, key=lambda r: r["written"])
    if replacement["nvcc_calls"] != 0:
        fail(f"20d: the replacement incarnation started nvcc {replacement}")

    # the same rows in process, and one BatchWorker on a 256-row ledger
    mark = len(CAPTURE_LOG)
    fm = fleet_bert(weights, str(dev), fresh_build=False)
    fm.warm((512,), FLEET_BATCH, dtype=np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fm.predict(x, batch_size=FLEET_BATCH)
    predict_s = time.perf_counter() - t0
    if want.tobytes() != got_ctl.tobytes():
        fail(f"20d: the fleet's outputs differ from in-process predict by "
             f"{float(np.abs(want - got_ctl).max())}")
    small = os.path.join(tmp, "fleet-small")
    os.makedirs(small)
    np.save(os.path.join(small, "x.npy"), x[:FLEET_SHARD])
    small_job = job(os.path.join(tmp, "fleet-out-small"), rows=FLEET_SHARD,
                    data=small)
    ShardManifest.create(small_job, os.path.join(tmp, "fleet-small-run"))
    kernels.reset_launch_counts()
    BatchWorker(small_job, os.path.join(tmp, "fleet-small-run"),
                source=NpyDirSource(small), model=fm).run()
    batches = FLEET_SHARD // FLEET_BATCH
    expect_launches(kernels.launch_counts(), {
        "flash_attention_fwd": 12 * batches, "bias_gelu": 12 * batches,
        "layernorm_act": batches}, "20d in-process BatchWorker")
    if outputs(os.path.join(tmp, "fleet-out-small"), 1).tobytes() != \
            got_ctl[:FLEET_SHARD].tobytes():
        fail("20d: the in-process worker's shard differs from the fleet's")
    report_captures("20d in-process", mark, card, allow_fallback=False)
    target = f"{control['target_deadline_s']:g}"
    print(f"20d fleet: BERT-base (phase 3's TextClassifier from a save_model "
          f"file, built in each worker by {os.path.basename(ref)}), "
          f"{FLEET_ROWS} x 512 tokens from an NpyDirSource, {FLEET_SHARD} rows "
          f"a shard, batch {FLEET_BATCH}, {FLEET_WORKERS} workers on one card: "
          f"control {control['rows_per_sec']} rows/s on the card, the "
          f"report's rows/s/chip {control['rows_per_sec_per_chip']} (it "
          f"counts a worker a chip), {control['elapsed_s']} s of job "
          f"({ctl_wall:.3f} s with the fleet's set-up), chips_for "
          f"{control['chips_for']} (target {target} s); in-process predict "
          f"{FLEET_ROWS / predict_s:.1f} rows/s; drill: worker 0 killed at "
          f"worker.step 1, {drill['restarts']} restart(s), "
          f"{res['rows_recomputed']} rows recomputed, "
          f"{res['duplicate_commits']} duplicate commits, resume overhead "
          f"fraction {res['resume_overhead_fraction']}; outputs of control, "
          f"drill and in-process predict byte-identical ({card})")
    hosts = {h: (v["rows"], round(v["seconds"], 3))
             for h, v in control["per_host"].items()}
    print(f"20d control, rows and shard-scoring seconds by worker {hosts}: "
          f"{FLEET_ROWS / max(v[1] for v in hosts.values()):.1f} rows a "
          f"second of the slower worker's scoring; the job's "
          f"{control['elapsed_s']} s include the workers' start-up "
          f"({card})")
    print(f"20d worker start-up, s from process start to a captured warm: "
          f"cold {[round(r['startup_s'], 3) for r in cold]} (nvcc processes "
          f"{[r['nvcc_calls'] for r in cold]}), replacement "
          f"{replacement['startup_s']:.3f} (nvcc processes "
          f"{replacement['nvcc_calls']}: the libraries from the run dir's "
          f"compile farm) ({card})")
    print(f"20d in-process BatchWorker: {batches} batches of "
          f"{FLEET_BATCH} x 512, launches {kernels.launch_counts()} "
          f"(12/12/1 a batch) ({card})")


def data_pipeline_phase(torch, card, dev) -> None:
    """Phase 20: the data pipeline and offline batch scoring (see the
    module docstring)."""
    import shutil
    import tempfile

    from analytics_zoo_torch.common.config import get_config
    cfg = get_config()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zoo-phase20-")
    prefetch = cfg.get("data.prefetch")
    try:
        cfg.set("data.prefetch", 2)
        pipeline_training(torch, card, dev, tmp)
        cfg.set("data.prefetch", prefetch)
        sps = input_pipeline_bench(torch, dev)
        print(f"20b input pipeline ({INPUT_ROWS} x {INPUT_HW}x{INPUT_HW}x3 "
              f"float32, batch {INPUT_BATCH}, {sps['sample_bytes']} bytes a "
              f"sample): samples/s bare {sps['bare']:.1f}, normalize map "
              f"{sps['map']:.1f}, in a pool of 4 {sps['pooled_map']:.1f}, "
              f"DeviceLoader to the card (2 workers, depth 2) "
              f"{sps['device_feed']:.1f}; CRC-32C (utils/crc32c.py) over "
              f"{CRC_BYTES} bytes on the host, MB/s "
              f"{[round(v, 3) for v in sps['crc32c_mb_s']]} ({card})")
        batch_scoring_bench(card, tmp)
        fleet_scoring(torch, card, dev, tmp)
    finally:
        cfg.set("data.prefetch", prefetch)
        shutil.rmtree(tmp, ignore_errors=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s ({card})")


def data_pipeline_alone() -> None:
    """Phase 20 by itself (``--data-pipeline``): the kernels built, then
    the pipeline training, the input-pipeline and batch-scoring benches
    and the BERT-base fleet on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    data_pipeline_phase(torch, card, ctx.device)


# ------------------------------------------ phase 21: images in (--images)
# 21a: bench_serving's workload (bench.py:486-600)
SERVE_RECORDS = 2048
SERVE_SIDE = 64
SERVE_BATCH = 32
# a served top-5 against predict's: the same rows through the same
# bucket; probabilities are compared at PROB_ATOL (phase 3b's bound), and
# the classes where the in-process probabilities of neighbouring ranks are
# more than this apart
SERVE_GAP = 1e-3
# 21b/21c: SSD-300 at batch 32, 16 boxes an image
SSD_BATCH = 32
SSD_MAX_BOXES = 16
SSD_TIMED = 5
SSD_TRAIN_WARM, SSD_TRAIN_TIMED = 2, 10
# card against CPU, float32 products: boxes and probabilities before NMS
# (a ~31-layer forward in other summation orders, ~1e-6 relative of a
# value), and detections compared where the CPU's scores of neighbouring
# detections are more than SSD_GAP apart
SSD_F32_ATOL = 1e-4
SSD_GAP = 1e-3
# 21c's VOC tree: 24 images of 64 x 64, ssd_lite, 8 classes
VOC_IMAGES, VOC_EPOCHS, VOC_MAX_EPOCHS = 24, 30, 90
# 21d: benchmarks/wide_deep.py's model and data at 1/8 of its rows, one
# epoch (22d runs the bench at its defaults)
NN_ROWS, NN_BATCH, NN_EPOCHS = 1 << 16, 8192, 1


def codec_name() -> str:
    """The codec ``feature/image`` decodes with; fails when none imports."""
    from analytics_zoo_torch.feature import image as timage
    if timage._HAS_CV2:
        import cv2
        return f"OpenCV {cv2.__version__}"
    try:
        import PIL
    except ImportError:
        fail("phase 21: neither cv2 nor PIL imports: no image codec")
    return f"PIL {PIL.__version__} (cv2 does not import)"


def encode_jpeg(img) -> bytes:
    """JPEG bytes of an HWC uint8 RGB-order array, as the client encodes
    an ndarray (OpenCV; PIL where OpenCV is missing)."""
    from analytics_zoo_torch.feature import image as timage
    if timage._HAS_CV2:
        import cv2
        return cv2.imencode(".jpg", img)[1].tobytes()
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(buf, "JPEG")
    return buf.getvalue()


def image_records(torch, card, n_records=SERVE_RECORDS, side=SERVE_SIDE,
                  batch=SERVE_BATCH, depth=18, classes=1000):
    """21a: ``bench_serving`` through the port: ResNet-18 at 64x64x3 and
    1000 classes (seeded weights), ``n_records`` JPEG records from
    ``RandomState(0)`` served at batch 32, top 5, on an ``EmbeddedBroker``
    sequentially, then pipelined (the serving thread), then calibrated
    int8; every served top 5 held to ``predict`` on the same decoded BGR
    arrays; a poison record answered with an error while the records
    after it are served."""
    import threading

    from analytics_zoo_torch.feature.image import decode_image_bytes
    from analytics_zoo_torch.models.image.imageclassification import resnet
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_torch.serving.engine.executor import ModelExecutor
    from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
    from analytics_zoo_torch.serving.server import (
        ClusterServing, ServingConfig)
    print(f"21a codec: {codec_name()} decodes the records ({card})")
    model = resnet(depth, num_classes=classes, input_shape=(side, side, 3))
    model.init(torch.Generator().manual_seed(0))
    im = InferenceModel().load_zoo(model)
    rs = np.random.RandomState(0)
    jpegs = [encode_jpeg((rs.rand(side, side, 3) * 255).astype(np.uint8))
             for _ in range(n_records)]

    def serving_on(im_pass):
        broker = EmbeddedBroker()
        serving = ClusterServing(im_pass, ServingConfig(
            batch_size=batch, top_n=5), broker=broker)
        inq = InputQueue(broker=broker)
        for i, data in enumerate(jpegs):
            inq.enqueue_image(f"rec-{i}", data)
        return serving, broker, inq

    # sequential: run_once until the stream is drained; the first pass
    # warms (captures) the padded-batch program and is not timed
    kernels.reset_launch_counts()
    serving, broker, inq = serving_on(im)
    serving.run_once(block_ms=0)
    warm_records = serving.total_records
    t0 = time.perf_counter()
    while serving.total_records < n_records:
        if serving.run_once(block_ms=0) == 0:
            break
    seq_wall = time.perf_counter() - t0
    seq_rps = (serving.total_records - warm_records) / max(seq_wall, 1e-9)
    if serving.total_records != n_records:
        fail(f"21a sequential pass served {serving.total_records} of "
             f"{n_records}")
    outq = OutputQueue(broker=broker)
    served = [outq.query(f"rec-{i}") for i in range(n_records)]
    # a poison record between two good ones
    inq.enqueue_image("poison", b"not-a-jpeg")
    inq.enqueue_image("after-0", jpegs[0])
    inq.enqueue_image("after-1", jpegs[1])
    while serving.run_once(block_ms=0):
        pass
    poison = outq.query("poison")
    after = [outq.query("after-0"), outq.query("after-1")]
    serving.close()
    if not isinstance(poison, dict) or "error" not in poison or \
            "cannot decode image poison" not in poison["error"]:
        fail(f"21a poison record: result {poison}")
    if after != served[:2]:
        fail(f"21a records after the poison record: {after} against "
             f"{served[:2]}")
    print(f"21a poison record: error result {poison['error']!r}; the two "
          "records after it served the same top 5 as their first copies")
    if sum(kernels.launch_counts().values()):
        fail(f"21a ResNet-18 serving launched kernels "
             f"{kernels.launch_counts()}: its path has none")

    # served top 5 against predict on the same decoded BGR arrays
    x = np.stack([decode_image_bytes(d, to_rgb=False) for d in jpegs]
                 ).astype(np.float32)
    want = ModelExecutor.postprocess(im.predict(x, batch_size=batch), 5)
    exact = compared = 0
    worst = 0.0
    for i, (got, ref) in enumerate(zip(served, want)):
        if not isinstance(got, list) or len(got) != 5:
            fail(f"21a record {i}: result {got}")
        exact += [c for c, _ in got] == [c for c, _ in ref]
        worst = max(worst, max(abs(p - q) for (_, p), (_, q) in
                               zip(got, ref)))
        probs = [q for _, q in ref]
        for k in range(5):
            gaps = [abs(probs[k] - probs[j]) for j in (k - 1, k + 1)
                    if 0 <= j < 5]
            if min(gaps) > SERVE_GAP:
                compared += 1
                if got[k][0] != ref[k][0]:
                    fail(f"21a record {i}: served top 5 {got} against "
                         f"predict's {ref}")
    if not worst <= PROB_ATOL:
        fail(f"21a served probabilities differ from predict's by {worst}")
    print(f"21a served top 5 against InferenceModel.predict on the same "
          f"decoded BGR arrays (batch {batch}): {exact} of {n_records} "
          f"records identical in all five classes; all {compared} ranks "
          f"whose neighbours' probabilities are more than {SERVE_GAP} apart "
          f"equal; probability max abs diff {worst:.3e} (tolerance "
          f"{PROB_ATOL})")

    def pipelined_pass(im_pass):
        serving_p, _, _ = serving_on(im_pass)
        t = threading.Thread(target=serving_p.run, kwargs={"poll_ms": 10})
        t0 = time.perf_counter()
        t.start()
        while serving_p.total_records < n_records and \
                time.perf_counter() - t0 < 300:
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        serving_p.stop()
        t.join(timeout=60)
        if t.is_alive():
            fail("21a ClusterServing.run did not stop")
        stats = serving_p.stats()
        n = serving_p.total_records
        serving_p.close()
        if n != n_records:
            fail(f"21a pipelined pass served {n} of {n_records}")
        return n / max(wall, 1e-9), stats

    pipe_rps, stats = pipelined_pass(im)
    calib = rs.rand(128, side, side, 3).astype(np.float32) * 255
    im8 = InferenceModel().load_zoo(model, quantize="calibrated",
                                    calib_set=calib)
    im8.predict(np.zeros((batch, side, side, 3), np.float32))
    int8_rps, int8_stats = pipelined_pass(im8)
    print(f"21a ResNet-{depth} {side}x{side}x3, {classes} classes, "
          f"{n_records} JPEG records, batch {batch}, top 5: sequential "
          f"{seq_rps:.1f} records/s, pipelined {pipe_rps:.1f} records/s, "
          f"latency p50 {stats['latency_p50_ms']:.3f} ms p95 "
          f"{stats['latency_p95_ms']:.3f} ms p99 "
          f"{stats['latency_p99_ms']:.3f} ms; calibrated int8 pipelined "
          f"{int8_rps:.1f} records/s, p50 "
          f"{int8_stats['latency_p50_ms']:.3f} ms ({card})")
    del im, im8, model
    torch.cuda.empty_cache()


def he_scaled(params) -> None:
    """Seeded random SSD weights made to behave like a trained detector's
    at the scale of its outputs: every kernel times sqrt(2) (He's gain
    for a ReLU: at the initializer's scale the activations halve in
    variance at each of the 15 layers, and every score is ~1/21), and the
    heads' kernels (the convolutions with a bias) times 4 more, so the
    scores spread and detections are not ties."""
    for p in params.values():
        if "kernel" in p:
            p["kernel"].mul_(2 ** 0.5 * (4.0 if "bias" in p else 1.0))


def ssd300_served(torch, card, dev, batch=SSD_BATCH, timed=SSD_TIMED):
    """21b: ``ObjectDetector("ssd_vgg300", num_classes=21)`` under the
    default policy: ``detect`` at batch 32 captured and eager in turns,
    then card against CPU on two images with float32 products.  Returns
    the detector."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    from analytics_zoo_torch.models.image.objectdetection import (
        ObjectDetector, SSDDetector, decode_boxes)
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.api.keras.topology import to_device
    cfg = get_config()
    t0 = time.perf_counter()
    det = ObjectDetector("ssd_vgg300", num_classes=21)
    v = det.get_variables()
    with torch.no_grad():
        he_scaled(v["params"])
    n_params = sum(int(p.numel()) for layer in v["params"].values()
                   for p in layer.values())
    print(f"21b SSD-300 (BN-VGG, {len(det.model.layers)} layers, "
          f"{n_params} params, {len(det.priors)} priors) built in "
          f"{time.perf_counter() - t0:.1f} s")
    x = (np.random.RandomState(21).rand(batch, 300, 300, 3).astype(
        np.float32) - 0.5) * 2
    mark = len(CAPTURE_LOG)
    kernels.reset_launch_counts()
    ms = {True: [], False: []}
    outs = {}
    for aot in (True, False, False, True):
        cfg.set("compile.aot", aot)
        outs[aot] = det.detect(x)                 # warm (captures once)
        for _ in range(timed):
            s0 = time.perf_counter()
            det.detect(x)                         # ends on the host
            ms[aot].append((time.perf_counter() - s0) * 1e3)
    cfg.set("compile.aot", True)
    caps = [c for c in CAPTURE_LOG[mark:] if c["fn"] == "ssd_detect"]
    if len(caps) != 1 or caps[0]["fallback"] is not None:
        fail(f"21b detect captures {caps}")
    if sum(kernels.launch_counts().values()):
        fail(f"21b detect launched kernels {kernels.launch_counts()}: its "
             "path has none")
    for (gb, gs, gl), (wb, ws, wl) in zip(outs[True], outs[False]):
        if not (np.array_equal(gb, wb) and np.array_equal(gs, ws) and
                np.array_equal(gl, wl)):
            fail("21b captured and eager detections differ")
    n_det = [len(o[2]) for o in outs[True]]
    for aot, name in ((True, "captured"), (False, "eager")):
        med = statistics.median(ms[aot])
        print(f"21b SSD-300 detect {name}, batch {batch} x 300x300x3, "
              f"in turns: median {med:.3f} ms, spread {min(ms[aot]):.3f}-"
              f"{max(ms[aot]):.3f} ms, {batch * 1e3 / med:.1f} images/s "
              f"({card})")
    print(f"21b detect captured once in {caps[0]['capture_s']:.3f} s (pool "
          f"{caps[0]['pool_bytes']} bytes); captured and eager detections "
          f"bit-identical; "
          f"detections an image {min(n_det)}-{max(n_det)} at score "
          f"threshold {det.score_threshold}")

    # card against CPU, float32 products, two images
    dtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    x2 = x[:2]
    vc = to_device(v, torch.device("cpu"))

    def raw(variables, device):
        priors = torch.as_tensor(det.priors).to(device)
        with torch.inference_mode():
            (loc, conf), _ = det.model.apply(
                variables["params"], torch.from_numpy(x2).to(device),
                state=variables["state"])
            return (decode_boxes(loc, priors).cpu().numpy(),
                    torch.softmax(conf, -1).cpu().numpy())
    (cb, cp), (hb, hp) = raw(v, dev), raw(vc, torch.device("cpu"))
    err_b, err_p = float(np.abs(cb - hb).max()), float(np.abs(cp - hp).max())
    if not (err_b <= SSD_F32_ATOL and err_p <= SSD_F32_ATOL):
        fail(f"21b card vs CPU before NMS: boxes {err_b}, probabilities "
             f"{err_p} (tolerance {SSD_F32_ATOL})")
    card_det = det.detect(x2)
    kw = dict(num_classes=21, score_threshold=det.score_threshold,
              iou_threshold=det.iou_threshold,
              max_detections=det.max_detections)
    det.model.set_variables(vc)
    cpu_det = SSDDetector(det.model, det.priors, **kw).detect(x2)
    det.model.set_variables(v)
    dtypes.restore_policy(None)
    compared = 0
    for i, ((gb, gs, gl), (wb, ws, wl)) in enumerate(zip(card_det, cpu_det)):
        if len(gl) != len(wl):
            fail(f"21b image {i}: {len(gl)} detections on the card, "
                 f"{len(wl)} on the CPU")
        gaps = np.abs(np.diff(ws))
        clear = np.ones(len(ws), bool)
        clear[1:] &= gaps > SSD_GAP
        clear[:-1] &= gaps > SSD_GAP
        for k in np.flatnonzero(clear):
            compared += 1
            if gl[k] != wl[k] or np.abs(gb[k] - wb[k]).max() > SSD_F32_ATOL \
                    or abs(gs[k] - ws[k]) > SSD_F32_ATOL:
                fail(f"21b image {i} detection {k}: card {gb[k]} {gs[k]} "
                     f"{gl[k]}, CPU {wb[k]} {ws[k]} {wl[k]}")
    print(f"21b card vs CPU, 2 images, float32 products: before NMS boxes "
          f"max abs err {err_b:.3e}, probabilities {err_p:.3e} (tolerance "
          f"{SSD_F32_ATOL}); detections {[len(d[2]) for d in card_det]}, "
          f"{compared} whose neighbours' CPU scores are more than {SSD_GAP} "
          f"apart equal (labels; boxes and scores within {SSD_F32_ATOL})")
    return det


def ssd_batch(rs, batch, max_boxes, size=300):
    """A synthetic detection batch: images and padded ground truths
    (1..max_boxes boxes an image, labels 1..20)."""
    x = (rs.rand(batch, size, size, 3).astype(np.float32) - 0.5) * 2
    lo = rs.uniform(0.0, 0.8, (batch, max_boxes, 2))
    wh = rs.uniform(0.05, 0.2, (batch, max_boxes, 2))
    boxes = np.concatenate([lo, np.minimum(lo + wh, 1.0)], -1).astype(
        np.float32)
    labels = rs.randint(1, 21, (batch, max_boxes)).astype(np.int32)
    n = rs.randint(1, max_boxes + 1, batch)
    mask = (np.arange(max_boxes)[None] < n[:, None]).astype(np.float32)
    return x, (boxes, labels, mask)


def ssd300_trained(torch, card, det, batch=SSD_BATCH,
                   max_boxes=SSD_MAX_BOXES, warm=SSD_TRAIN_WARM,
                   timed=SSD_TRAIN_TIMED):
    """21c: MultiBox loss steps on SSD-300 at batch 32 and 16 boxes under
    Adam: step ms, peak memory and launches (the Adam kernel once a
    step); returns the launch counts and the Adam kernel's numbers at
    SSD-300's leaves."""
    from analytics_zoo_torch.models.image.objectdetection import (
        MultiBoxLoss)
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    tr = DistributedTrainer(det.model, MultiBoxLoss(det.priors),
                            optim_method=Adam(lr=1e-4))
    v = det.get_variables()
    params = tr.place_params(v["params"])
    state = tr.replicate(v["state"])
    opt_state = tr.init_opt_state(params)
    batch_dev = tr.put_batch(ssd_batch(np.random.RandomState(22), batch,
                                       max_boxes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ms, losses = [], []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        params, opt_state, state, loss = tr.train_step(
            params, opt_state, state, batch_dev, None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - s0) * 1e3)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, {"fused_adam": warm + timed},
                    "21c SSD-300 train_step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"21c SSD-300 losses {losses}")
    steady = ms[warm:]
    med = statistics.median(steady)
    print(f"21c SSD-300 MultiBoxLoss train_step, batch {batch} x 300x300x3, "
          f"{max_boxes} boxes, Adam: median {med:.3f} ms, spread "
          f"{min(steady):.3f}-{max(steady):.3f} ms over {timed} steps "
          f"(first {warm}: {[round(t, 3) for t in ms[:warm]]} ms, capture "
          f"inside), {batch * 1e3 / med:.1f} images/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches} "
          f"({launches['fused_adam'] // (warm + timed)} fused_adam a step), "
          f"losses {[round(x, 5) for x in losses]} ({card})")
    leaves = tree_leaves(params)
    errs = opt_leaves_check(torch, leaves, "SSD-300")
    times = time_updates(torch, leaves, card, "SSD-300")
    del tr, params, opt_state, state, batch_dev, leaves
    torch.cuda.empty_cache()
    return launches, errs, times


def write_voc_tree(root, n=VOC_IMAGES, size=64, seed=1):
    """A VOCdevkit tree written from a seed (the JAX package's
    ``tests/test_objectdetection.py::_write_voc``): dark images with one
    bright square, a ``car`` box around it and an unknown class's box."""
    rs = np.random.RandomState(seed)
    for d in ("JPEGImages", "Annotations"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        img = (rs.rand(size, size, 3) * 40).astype(np.uint8)
        w = rs.randint(size // 4, size // 2)
        x0 = rs.randint(0, size - w)
        y0 = rs.randint(0, size - w)
        img[y0:y0 + w, x0:x0 + w] = 255
        img_id = f"img{i:03d}"
        with open(os.path.join(root, "JPEGImages", img_id + ".jpg"),
                  "wb") as f:
            f.write(encode_jpeg(img))
        with open(os.path.join(root, "Annotations", img_id + ".xml"),
                  "w") as f:
            f.write(
                f"<annotation><object><name>car</name><difficult>0"
                f"</difficult><bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}"
                f"</ymin><xmax>{x0 + w + 1}</xmax><ymax>{y0 + w + 1}</ymax>"
                f"</bndbox></object><object><name>unknown_thing</name>"
                f"<bndbox><xmin>1</xmin><ymin>1</ymin><xmax>5</xmax><ymax>5"
                f"</ymax></bndbox></object></annotation>")


def voc_pipeline_training(torch, card, n_images=VOC_IMAGES,
                          epochs=VOC_EPOCHS, max_epochs=VOC_MAX_EPOCHS):
    """21c's second half: a VOC tree written here goes through
    ``read_voc >> DetHFlip >> DetResize >> DetNormalize >>
    to_feature_set`` and trains ``ssd_lite`` at 64x64 (8 classes, batch
    8, Adam) until its mAP beats the untrained model's."""
    import tempfile

    from analytics_zoo_torch.feature.image_detection import (
        DetectionSet, DetHFlip, DetNormalize, DetResize)
    from analytics_zoo_torch.models.image.objectdetection import (
        MeanAveragePrecision, MultiBoxLoss, SSDDetector, ssd_lite)
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_voc_tree(root, n_images)
        ds = DetectionSet.read_voc(root) \
            >> DetHFlip(prob=0.5, seed=2) \
            >> DetResize(64, 64) \
            >> DetNormalize((127.5, 127.5, 127.5), (127.5, 127.5, 127.5))
        fs = ds.to_feature_set(max_boxes=4, shuffle=True)
        read_s = time.perf_counter() - t0
    model, priors = ssd_lite(num_classes=8, image_size=64)
    model.init(torch.Generator().manual_seed(0))
    tr = DistributedTrainer(model, MultiBoxLoss(priors),
                            optim_method=Adam(lr=3e-3))
    v = model.get_variables()
    params = tr.place_params(v["params"])
    state = tr.replicate(v["state"])
    opt_state = tr.init_opt_state(params)

    def eval_map():
        model.set_variables({"params": params, "state": state})
        det = SSDDetector(model, priors, num_classes=8, score_threshold=0.25)
        m = MeanAveragePrecision(num_classes=8)
        boxes, labels, mask = fs.y
        for r, gb, gl, gm in zip(det.detect(fs.x), boxes, labels, mask):
            keep = gm > 0
            m.add(r[0], r[1], r[2], gb[keep], gl[keep])
        return m.result()["mAP"]

    before = eval_map()
    kernels.reset_launch_counts()
    steps, after, t0 = 0, before, time.perf_counter()
    for epoch in range(max_epochs):
        for batch in tr.prefetch(fs.epoch_batches(epoch, 8, train=True)):
            params, opt_state, state, _ = tr.train_step(
                params, opt_state, state, batch, None)
            steps += 1
        if (epoch + 1) % epochs == 0:
            after = eval_map()
            if after > before:
                break
    train_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": steps}, "21c ssd_lite fit")
    if not after > before:
        fail(f"21c ssd_lite mAP {after} after {epoch + 1} epochs does not "
             f"beat the untrained model's {before}")
    print(f"21c VOC tree of {n_images} JPEGs + XML read through read_voc >> "
          f"DetHFlip >> DetResize >> DetNormalize >> to_feature_set in "
          f"{read_s:.3f} s; ssd_lite 64x64 trained {epoch + 1} epochs "
          f"({steps} steps of 8, Adam, {launches['fused_adam']} fused_adam "
          f"launches) in {train_s:.3f} s: mAP {before:.4f} untrained, "
          f"{after:.4f} trained ({card})")


def nnframes_wide_deep(torch, card, rows=NN_ROWS, batch=NN_BATCH,
                       epochs=NN_EPOCHS):
    """21d: ``NNClassifier`` on ``benchmarks/wide_deep.py``'s Wide & Deep
    and data (``census_wide_deep``: a packed ``features`` column,
    ``SplitColumns``, ``Adam(1e-3)``) at fewer rows, for what 22d's bench
    does not check: a saved and reloaded ``NNClassifierModel`` predicts
    what the fitted one did, one ``fused_adam`` a step; returns the
    launches, and the Adam kernel's numbers at the model's leaves (22d
    measures the fit and ``transform`` at the bench's defaults)."""
    import tempfile

    import pandas as pd

    from analytics_zoo_torch.benchmarks.wide_deep import census_wide_deep
    from analytics_zoo_torch.feature.common import SplitColumns
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.pipeline.nnframes import (
        NNClassifier, NNClassifierModel, NNModel)
    model, packed, sizes, label = census_wide_deep(rows)
    model.model.init(torch.Generator().manual_seed(0))
    df = pd.DataFrame({"features": list(packed), "label": label})
    clf = (NNClassifier(model.model,
                        "sparse_categorical_crossentropy_with_logits",
                        feature_preprocessing=SplitColumns(sizes))
           .set_batch_size(batch).set_max_epoch(epochs)
           .set_optim_method(Adam(lr=1e-3)))
    kernels.reset_launch_counts()
    nn_model = clf.fit(df)
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": rows // batch * epochs},
                    "21d NNClassifier.fit")
    history = clf.fitted_estimator.history
    if len(history) != epochs or not all(
            np.isfinite(h["loss"]) for h in history):
        fail(f"21d NNClassifier history {history}")
    pred = np.asarray(nn_model.transform(df)["prediction"].to_numpy())
    acc = float(np.mean(pred == label))
    if not isinstance(nn_model, NNClassifierModel) or pred.shape != (rows,) \
            or not acc > 0.5:
        fail(f"21d transform: {type(nn_model).__name__}, predictions "
             f"{pred.shape}, accuracy {acc}")
    with tempfile.TemporaryDirectory() as tmp:
        nn_model.save(os.path.join(tmp, "m"))
        loaded = NNModel.load(os.path.join(tmp, "m"))
    again = np.asarray(loaded.transform(df)["prediction"].to_numpy())
    if type(loaded) is not NNClassifierModel or \
            not np.array_equal(again, pred):
        fail(f"21d the reloaded {type(loaded).__name__} predicts otherwise "
             f"on {int(np.sum(again != pred))} of {rows} rows")
    print(f"21d NNClassifier on Wide & Deep (census_wide_deep, {rows} rows, "
          f"batch {batch}, {epochs} epoch, Adam(1e-3), pandas "
          f"{pd.__version__}): losses "
          f"{[round(h['loss'], 5) for h in history]}, train accuracy "
          f"{acc:.4f}; launches {launches}; the saved and reloaded "
          f"NNClassifierModel predicts the same {rows} rows ({card})")
    leaves = tree_leaves(model.get_variables()["params"])
    errs = opt_leaves_check(torch, leaves, "Wide & Deep under NNClassifier")
    times = time_updates(torch, leaves, card,
                         "Wide & Deep under NNClassifier")
    return launches, errs, times


def images_phase(torch, card, dev):
    """Phase 21: image records served (21a), SSD-300 served (21b) and
    trained with the VOC pipeline (21c), NNFrames on Wide & Deep (21d).
    Returns the SSD-300 training launches and the Adam kernel's errors
    and times at SSD-300's and W&D's leaves."""
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    t_phase = time.perf_counter()
    mark = len(CAPTURE_LOG)
    image_records(torch, card)
    report_captures("21a", mark, card)
    mark = len(CAPTURE_LOG)
    det = ssd300_served(torch, card, dev)
    ssd_launches, ssd_errs, ssd_times = ssd300_trained(torch, card, det)
    del det
    voc_pipeline_training(torch, card)
    report_captures("21b-21c", mark, card)
    mark = len(CAPTURE_LOG)
    _, wd_errs, wd_times = nnframes_wide_deep(torch, card)
    report_captures("21d", mark, card)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return ssd_launches, {k: max(ssd_errs[k], wd_errs[k])
                          for k in ssd_errs}, ssd_times, wd_times


def images_alone() -> None:
    """Phase 21 by itself (``--images``): the kernels built, then image
    records, SSD-300 and NNFrames on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    images_phase(torch, card, ctx.device)


# ------------------------------------- 22. models from other frameworks
class _StandInLayer:
    """One layer of ``KerasStandIn``: what the converter reads of a
    tf.keras layer (its subclass is named as the Keras class, because
    ``_copy_weights`` dispatches on ``type(layer).__name__``)."""

    def __init__(self, entry, config, weights):
        self.name = entry["name"]
        self._config = config
        self._build = entry["build_config"]
        self._weights = weights

    def get_config(self):
        return json.loads(json.dumps(self._config))

    def get_build_config(self):
        return self._build

    def get_weights(self):
        return list(self._weights)


class KerasStandIn:
    """A stand-in for a compiled tf.keras functional model, made from a
    ``benchmarks.inception.keras_spec`` file where TensorFlow is not
    installed: ``get_config()``, ``get_layer(name)``, ``layers``, each
    layer's config, build config, class name and weights (drawn from
    ``seed`` with numpy: kernels normal with He's variance, biases
    normal x 0.01), and the compile facts (``loss``, ``optimizer`` with
    its class name and ``learning_rate``, ``metrics_names``)."""

    def __init__(self, spec, seed=0):
        rs = np.random.RandomState(seed)
        configs = {lc["name"]: lc["config"]
                   for lc in spec["config"]["layers"]}
        self.layers = []
        for entry in spec["layers"]:
            weights = []
            for shape in entry["weight_shapes"]:
                if len(shape) >= 2:
                    fan_in = int(np.prod(shape[:-1]))
                    w = rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                else:
                    w = rs.standard_normal(shape) * 0.01
                weights.append(w.astype(np.float32))
            cls = type(entry["class_name"], (_StandInLayer,), {})
            self.layers.append(cls(entry, configs.get(entry["name"], {}),
                                   weights))
        self._by_name = {layer.name: layer for layer in self.layers}
        self._config = spec["config"]
        facts = spec["compile"]
        self.loss = facts["loss"]
        self.optimizer = type(facts["optimizer"], (), {})()
        self.optimizer.learning_rate = np.float32(facts["learning_rate"])
        self.metrics_names = list(facts["metrics_names"])

    def get_config(self):
        return json.loads(json.dumps(self._config))

    def get_layer(self, name):
        return self._by_name[name]


INCEPTION_SEED = 0
INCEPTION_CHECK_ROWS = 4          # the card-against-CPU eval forward
INCEPTION_PROB_RTOL = 1e-4        # of the probabilities' largest value
ONNX_BATCH = 32
ONNX_TURN_CALLS = 5               # timed predicts a turn
ONNX_TRAIN_STEPS = 5
ONNX_CHECK_ROWS = 4
ONNX_RTOL = 1e-4                  # card against CPU logits, relative L2
TORCHNET_BATCH = 32
TORCHNET_RTOL = 1e-4              # served logits against the module's own
TORCHNET_TRAIN_STEPS = 20
GAN_STEPS = 20
GAN_ATOL = 1e-5
TF_ONLY = ("TFNet", "InferenceModel.load_tf", "Net.load_tf",
           "TFOptimizer.from_train_op (tf1_graph)",
           "TFDataset.from_tf_data_dataset",
           "benchmarks.inception.build_tf_inception_v1")


def inception_tfpark(torch, card, dev):
    """22a: Inception-v1 (BASELINE config 4) converted by ``KerasModel``
    from a stand-in for the tf.keras model built from the committed
    ``inception_v1.json``, then ``run_inception_bench`` at its defaults
    (the stand-in in place of TensorFlow's builder): convert s, samples/s
    an epoch, fit wall s, peak memory, SGD launches a step; the eval
    forward of 4 images card against CPU under float32 products; one
    ``TFOptimizer.from_keras`` ``optimize`` of one epoch of 2 iterations
    on a ``TFDataset.from_ndarrays``.  Returns the SGD launches, the kernels'
    errors and times at the model's leaves."""
    from analytics_zoo_torch.benchmarks import inception
    from analytics_zoo_torch.common.triggers import MaxEpoch
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.tfpark import KerasModel, TFDataset, TFOptimizer
    spec = inception.inception_v1_spec()
    stand_in = KerasStandIn(spec, seed=INCEPTION_SEED)

    def builder(num_classes=1000, image_size=224):
        if (num_classes, image_size) != (1000, 224):
            fail(f"22a the bench asked for Inception-v1 at {num_classes} "
                 f"classes, {image_size}: the committed spec is 1000, 224")
        return stand_in
    real_builder = inception.build_tf_inception_v1
    inception.build_tf_inception_v1 = builder
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        r = inception.run_inception_bench(dev)
    finally:
        inception.build_tf_inception_v1 = real_builder
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = r["rows"] // r["batch_size"] * len(r["epoch_throughputs"])
    expect_launches(launches, {"fused_sgd": steps},
                    "22a Inception-v1 KerasModel.fit")
    if not np.isfinite(r["value"]) or r["tf_layers_converted"] != 83:
        fail(f"22a Inception-v1 bench {r}")
    print(f"22a Inception-v1 through TFPark's KerasModel (stand-in from "
          f"inception_v1.json, {r['tf_layers_converted']} tf.keras layers, "
          f"6998552 params; SGD(lr {spec['compile']['learning_rate']}) as "
          f"the reference maps it, momentum dropped): convert "
          f"{r['convert_time_s']} s; fit {r['rows']} rows x "
          f"{r['image_size']}x{r['image_size']}, batch {r['batch_size']}, "
          f"{len(r['epoch_throughputs'])} epochs: imgs/s an epoch "
          f"{r['epoch_throughputs']} (median of the timed epochs "
          f"{r['value']}), fit wall {r['fit_wall_s']} s, peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches} ({steps} steps: "
          f"{launches['fused_sgd'] / steps:.0f} SGD a step); device_kind "
          f"{r['device_kind']} ({card})")
    # card against CPU: the eval forward of 4 images, float32 products
    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    x = np.random.RandomState(1).rand(INCEPTION_CHECK_ROWS, 224, 224, 3) \
        .astype(np.float32)
    card_model = KerasModel(stand_in)
    got = card_model.predict(x, batch_size=INCEPTION_CHECK_ROWS)
    with zoo_device("cpu"):
        want = KerasModel(stand_in).predict(x,
                                            batch_size=INCEPTION_CHECK_ROWS)
    dtypes.restore_policy(default)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"22a Inception-v1 eval forward, {INCEPTION_CHECK_ROWS} images, "
          f"card vs CPU on the same converted weights (float32 products): "
          f"max abs err {err:.3e}, probabilities' largest {scale:.3e} "
          f"(tolerance {INCEPTION_PROB_RTOL} of it); rows sum to "
          f"{np.round(got.sum(-1), 6).tolist()}")
    if got.shape != (INCEPTION_CHECK_ROWS, 1000) or \
            not err <= INCEPTION_PROB_RTOL * scale:
        fail(f"22a Inception-v1 card and CPU disagree: {err} > "
             f"{INCEPTION_PROB_RTOL} x {scale}")
    # TFOptimizer.from_keras over a TFDataset, 2 iterations
    rs = np.random.RandomState(2)
    xs = rs.rand(128, 224, 224, 3).astype(np.float32)
    ys = rs.randint(0, 1000, (128, 1))
    kernels.reset_launch_counts()
    opt = TFOptimizer.from_keras(stand_in, TFDataset.from_ndarrays(
        (xs, ys), batch_size=64))
    t0 = time.perf_counter()
    hist = opt.optimize(end_trigger=MaxEpoch(1))
    opt_s = time.perf_counter() - t0
    opt_launches = kernels.launch_counts()
    expect_launches(opt_launches, {"fused_sgd": 2},
                    "22a TFOptimizer.from_keras optimize")
    if not hist or not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"22a TFOptimizer history {hist}")
    print(f"22a TFOptimizer.from_keras(stand-in, TFDataset.from_ndarrays(128 "
          f"rows, batch 64)).optimize(MaxEpoch(1)): 2 iterations in "
          f"{opt_s:.3f} s, loss "
          f"{[round(h['loss'], 5) for h in hist]}, launches {opt_launches} "
          f"({card})")
    leaves = tree_leaves(card_model.model.get_variables()["params"])
    # SGD at momentum 0, as the fit above ran it: the kernel's branch
    # without a trace
    errs = opt_leaves_check(torch, leaves, "Inception-v1", sgd_momentum=0.0)
    times = time_updates(torch, leaves, card, "Inception-v1",
                         sgd_momentum=0.0)
    del card_model, opt, xs
    torch.cuda.empty_cache()
    return launches, errs, times


def _he(rs, shape):
    fan_in = int(np.prod(shape[1:]))
    return (rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
        np.float32)


def resnet50_onnx(seed=0, classes=1000):
    """ResNet-50 v1 as an ONNX ``ModelProto`` written with the port's
    codec, in the op set and layout of the public ONNX model zoo's
    ``resnet50-v1-7``: Conv (no bias) + BatchNormalization + Relu, a 3x3/2
    MaxPool, bottlenecks striding in their first 1x1 conv with a 1x1
    projection shortcut, Add, GlobalAveragePool, Flatten and Gemm, 224 x
    224 x 3 NCHW in, ``classes`` logits out.  Weights are drawn from
    ``seed``: convolutions He-normal, BatchNormalization statistics near
    (0, 1), each residual branch's last scale 0.2.  Returns the bytes."""
    from analytics_zoo_torch.pipeline.api.onnx import onnx_pb as pb
    rs = np.random.RandomState(seed)
    nodes, inits = [], []

    def ints(name, v):
        return pb.AttributeProto(name=name, ints=list(v),
                                 type=pb.AttributeProto.INTS)

    def const(name, arr):
        inits.append(pb.ndarray_to_tensor(arr, name))
        return name

    def conv_bn(x, c_in, c_out, k, stride, name, relu=True, gamma=1.0):
        w = const(f"{name}_w", _he(rs, (c_out, c_in, k, k)))
        nodes.append(pb.NodeProto(
            input=[x, w], output=[f"{name}_conv"], op_type="Conv",
            name=f"{name}_conv",
            attribute=[ints("kernel_shape", (k, k)),
                       ints("strides", (stride, stride)),
                       ints("pads", (k // 2,) * 4)]))
        bn = [const(f"{name}_{p}", v) for p, v in (
            ("gamma", (gamma * (1 + 0.1 * rs.standard_normal(c_out)))
             .astype(np.float32)),
            ("beta", (0.1 * rs.standard_normal(c_out)).astype(np.float32)),
            ("mean", (0.1 * rs.standard_normal(c_out)).astype(np.float32)),
            ("var", (1 + 0.1 * rs.rand(c_out)).astype(np.float32)))]
        nodes.append(pb.NodeProto(
            input=[f"{name}_conv"] + bn, output=[f"{name}_bn"],
            op_type="BatchNormalization", name=f"{name}_bn",
            attribute=[pb.AttributeProto(name="epsilon", f=1e-5,
                                         type=pb.AttributeProto.FLOAT)]))
        if not relu:
            return f"{name}_bn"
        nodes.append(pb.NodeProto(input=[f"{name}_bn"],
                                  output=[f"{name}_relu"], op_type="Relu",
                                  name=f"{name}_relu"))
        return f"{name}_relu"

    x = conv_bn("data", 3, 64, 7, 2, "stem")
    nodes.append(pb.NodeProto(
        input=[x], output=["pool0"], op_type="MaxPool", name="pool0",
        attribute=[ints("kernel_shape", (3, 3)), ints("strides", (2, 2)),
                   ints("pads", (1, 1, 1, 1))]))
    x, c_in = "pool0", 64
    for stage, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256),
                                             (3, 512))):
        for b in range(blocks):
            name = f"stage{stage + 1}_unit{b + 1}"
            stride = 2 if b == 0 and stage > 0 else 1
            h = conv_bn(x, c_in, width, 1, stride, f"{name}_a")
            h = conv_bn(h, width, width, 3, 1, f"{name}_b")
            h = conv_bn(h, width, 4 * width, 1, 1, f"{name}_c", relu=False,
                        gamma=0.2)
            short = x if b else conv_bn(x, c_in, 4 * width, 1, stride,
                                        f"{name}_sc", relu=False)
            nodes.append(pb.NodeProto(input=[h, short],
                                      output=[f"{name}_add"], op_type="Add",
                                      name=f"{name}_add"))
            nodes.append(pb.NodeProto(input=[f"{name}_add"],
                                      output=[f"{name}_out"], op_type="Relu",
                                      name=f"{name}_out"))
            x, c_in = f"{name}_out", 4 * width
    nodes.append(pb.NodeProto(input=[x], output=["gap"],
                              op_type="GlobalAveragePool", name="gap"))
    nodes.append(pb.NodeProto(input=["gap"], output=["flat"],
                              op_type="Flatten", name="flat"))
    fc_w = const("fc_w", (rs.standard_normal((classes, 2048)) *
                          np.sqrt(1.0 / 2048)).astype(np.float32))
    fc_b = const("fc_b", np.zeros(classes, np.float32))
    nodes.append(pb.NodeProto(
        input=["flat", fc_w, fc_b], output=["logits"], op_type="Gemm",
        name="fc", attribute=[pb.AttributeProto(
            name="transB", i=1, type=pb.AttributeProto.INT)]))
    graph = pb.GraphProto(
        node=nodes, name="resnet50_v1", initializer=inits,
        input=[pb.make_value_info("data", [0, 3, 224, 224])],
        output=[pb.make_value_info("logits", [0, classes])])
    return pb.ModelProto(
        ir_version=7, producer_name="chip_smoke", graph=graph,
        opset_import=[pb.OperatorSetIdProto(domain="", version=11)]).encode()


def onnx_resnet50(torch, card, dev):
    """22b: ResNet-50 v1 written as ONNX, imported through
    ``Net.load_onnx(bytes)``, served through ``InferenceModel.load_zoo``
    at batch 32 (captured and eager in turns), held to the CPU under
    float32 products, and trained 5 Adam steps at batch 32 (one Adam launch
    a step).  Returns the Adam launches, the kernels' errors and times at
    the imported model's leaves."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.pipeline.api.net import Net
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    t0 = time.perf_counter()
    data = resnet50_onnx()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Net.load_onnx(data)
    model.init()
    load_s = time.perf_counter() - t0
    leaves = tree_leaves(model.get_variables()["params"])
    n_params = sum(int(x.numel()) for x in leaves)
    print(f"22b ResNet-50 v1 as ONNX (the resnet50-v1-7 op set, seeded "
          f"weights): {len(data)} bytes written in {write_s:.3f} s; "
          f"Net.load_onnx + init {load_s:.3f} s: {len(model.layers)} layers, "
          f"{len(leaves)} param leaves, {n_params} params ({card})")
    if n_params != 25_557_032 + 2 * 26_560:
        fail(f"22b ResNet-50 has {n_params} params (weights 25,557,032 "
             "and 26,560 BatchNormalization statistics x 2 expected)")
    im = InferenceModel().load_zoo(model)
    x = np.random.RandomState(3).randn(ONNX_BATCH, 3, 224, 224).astype(
        np.float32)
    kernels.reset_launch_counts()
    lat = {"captured": [], "eager": []}
    outs = {}
    for mode in ("captured", "eager", "eager", "captured"):
        get_config().set("compile.aot", mode == "captured")
        outs[mode] = im.predict(x, batch_size=ONNX_BATCH)
        for _ in range(ONNX_TURN_CALLS):
            s0 = time.perf_counter()
            outs[mode] = im.predict(x, batch_size=ONNX_BATCH)
            lat[mode].append((time.perf_counter() - s0) * 1e3)
    get_config().set("compile.aot", True)
    if sum(kernels.launch_counts().values()):
        fail(f"22b ResNet-50 predict launched {kernels.launch_counts()}: "
             "its path has no kernel")
    same = float(np.abs(outs["captured"] - outs["eager"]).max())
    for mode, v in lat.items():
        med = statistics.median(v)
        print(f"22b ResNet-50 (ONNX) predict, batch {ONNX_BATCH} x "
              f"3x224x224, {mode}, in turns: median {med:.3f} ms over "
              f"{[round(t, 3) for t in v]}, {ONNX_BATCH * 1e3 / med:.1f} "
              f"images/s ({card})")
    print(f"22b captured and eager logits: max abs difference {same:.3e}")
    if outs["captured"].shape != (ONNX_BATCH, 1000) or \
            not np.isfinite(outs["captured"]).all():
        fail(f"22b ResNet-50 logits {outs['captured'].shape}")
    # card against CPU, float32 products
    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    got = im.predict(x[:ONNX_CHECK_ROWS], batch_size=ONNX_CHECK_ROWS)
    want = cpu_forward(torch, model, x[:ONNX_CHECK_ROWS])
    dtypes.restore_policy(default)
    err = rel_l2(torch.from_numpy(got), torch.from_numpy(want))
    print(f"22b ResNet-50 (ONNX) card vs CPU logits ({ONNX_CHECK_ROWS} "
          f"images, float32 products): relative L2 {err:.3e} (tolerance "
          f"{ONNX_RTOL}), logits max abs {float(np.abs(want).max()):.3e}")
    if not err <= ONNX_RTOL:
        fail(f"22b ResNet-50 card and CPU logits differ: {err}")
    del im
    # training: Adam through the trainer's captured step
    tr = DistributedTrainer(model, objectives.get(
        "sparse_categorical_crossentropy_with_logits"),
        optim_method=Adam(lr=1e-4))
    v = model.get_variables()
    params = tr.place_params(v["params"])
    state = tr.replicate(v["state"])
    opt_state = tr.init_opt_state(params)
    y = np.random.RandomState(4).randint(0, 1000, ONNX_BATCH)
    batch = tr.put_batch((x, y))
    kernels.reset_launch_counts()
    step_ms, losses = [], []
    for _ in range(ONNX_TRAIN_STEPS):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        params, opt_state, state, loss = tr.train_step(
            params, opt_state, state, batch, None)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": ONNX_TRAIN_STEPS},
                    "22b ResNet-50 (ONNX) train_step")
    if not all(np.isfinite(losses)):
        fail(f"22b ResNet-50 losses {losses}")
    shown = [round(t, 3) for t in step_ms]
    print(f"22b ResNet-50 (ONNX) train_step, batch {ONNX_BATCH}, "
          f"Adam(1e-4), {len(leaves)} leaves: step ms {shown} (median of "
          f"the last {ONNX_TRAIN_STEPS - 1} "
          f"{statistics.median(step_ms[1:]):.3f}), losses "
          f"{[round(l_, 5) for l_ in losses]}, launches {launches} "
          f"({launches['fused_adam'] / ONNX_TRAIN_STEPS:.0f} Adam a step) "
          f"({card})")
    errs = opt_leaves_check(torch, leaves, "ResNet-50 (ONNX)")
    times = time_updates(torch, leaves, card, "ResNet-50 (ONNX)")
    del tr, params, opt_state, model
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, errs, times


def resnet18_module(torch, classes=1000):
    """ResNet-18 as a plain ``torch.nn.Module`` (BasicBlocks; torchvision's
    layout, written here: there is no torchvision on the card's machine)."""
    nn = torch.nn

    class Basic(nn.Module):
        def __init__(self, c_in, c_out, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(c_out)
            self.relu = nn.ReLU()
            self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(c_out)
            self.down = None
            if stride != 1 or c_in != c_out:
                self.down = nn.Sequential(
                    nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                    nn.BatchNorm2d(c_out))

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            short = x if self.down is None else self.down(x)
            return self.relu(out + short)

    class ResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            blocks, c_in = [], 64
            for c_out, stride in ((64, 1), (64, 1), (128, 2), (128, 1),
                                  (256, 2), (256, 1), (512, 2), (512, 1)):
                blocks.append(Basic(c_in, c_out, stride))
                c_in = c_out
            self.blocks = nn.Sequential(*blocks)
            self.avgpool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(512, classes)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.avgpool(self.blocks(x))
            return self.fc(torch.flatten(x, 1))
    return ResNet18()


def torchnet_phase(torch, card, dev):
    """22c: a ResNet-18 ``nn.Module`` served through
    ``InferenceModel.load_torch`` at batch 32, its logits held to the
    module's own forward on the card; a BatchNorm-free convnet TorchNet
    trained 20 Adam steps with a ``TorchCriterion``; the ResNet-18's
    training refused (BatchNorm's integer ``num_batches_tracked``).
    Returns the training launches."""
    from analytics_zoo_torch.ops import dtypes, kernels
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.net import TorchCriterion, TorchNet
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    nn = torch.nn
    torch.manual_seed(0)
    module = resnet18_module(torch).eval()
    rs = np.random.RandomState(5)
    for m in module.modules():       # BatchNorm statistics off (0, 1)
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rs.standard_normal(n)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                (1 + 0.1 * rs.rand(n)).astype(np.float32)))
    t0 = time.perf_counter()
    im = InferenceModel().load_torch(module, (3, 224, 224))
    load_s = time.perf_counter() - t0
    x = rs.randn(TORCHNET_BATCH, 3, 224, 224).astype(np.float32)
    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    kernels.reset_launch_counts()
    im.predict(x, batch_size=TORCHNET_BATCH)
    lat = []
    for _ in range(ONNX_TURN_CALLS):
        s0 = time.perf_counter()
        got = im.predict(x, batch_size=TORCHNET_BATCH)
        lat.append((time.perf_counter() - s0) * 1e3)
    dtypes.restore_policy(default)
    if sum(kernels.launch_counts().values()):
        fail(f"22c TorchNet predict launched {kernels.launch_counts()}")
    module_dev = module.to(dev)
    with torch.no_grad():
        own = module_dev(torch.from_numpy(x).to(dev)).cpu().numpy()
    err = rel_l2(torch.from_numpy(got), torch.from_numpy(own))
    med = statistics.median(lat)
    print(f"22c ResNet-18 nn.Module through InferenceModel.load_torch "
          f"(fx graph emitted on its own params; load {load_s:.3f} s): "
          f"predict batch {TORCHNET_BATCH} x 3x224x224, float32 products, "
          f"median {med:.3f} ms over {[round(t, 3) for t in lat]}, "
          f"{TORCHNET_BATCH * 1e3 / med:.1f} images/s; logits vs the "
          f"module's own forward on the card (no_grad, float32 products): "
          f"relative L2 {err:.3e} (tolerance {TORCHNET_RTOL}) ({card})")
    if got.shape != (TORCHNET_BATCH, 1000) or not err <= TORCHNET_RTOL:
        fail(f"22c TorchNet ResNet-18 logits differ from the module's: {err}")
    del im, module_dev
    # BatchNorm's integer leaf: training refused, as in the reference
    bn_model = Sequential()
    bn_model.add(TorchNet.from_pytorch(module.cpu(), input_shape=(3, 224,
                                                                  224)))
    bn_model.compile(Adam(lr=1e-3), "sparse_categorical_crossentropy_with_"
                     "logits")
    try:
        rows = min(8, len(x))
        bn_model.fit(x[:rows], np.zeros(rows, np.int64), batch_size=rows,
                     nb_epoch=1)
    except TypeError as e:
        if "num_batches_tracked" not in str(e):
            fail(f"22c the BatchNorm TorchNet's refusal names no leaf: {e}")
        print(f"22c ResNet-18 TorchNet fit refused as in the reference "
              f"(ROADMAP queue 3, fault (b)): TypeError: {e}")
    else:
        fail("22c a TorchNet over BatchNorm trained: its integer "
             "num_batches_tracked leaf must be refused")
    del bn_model
    # a BatchNorm-free convnet trained with a TorchCriterion (MSE on one-hot
    # targets: the reference's emitter does not take F.cross_entropy)
    torch.manual_seed(1)
    conv = nn.Sequential(nn.Conv2d(3, 32, 3, 2, 1), nn.ReLU(),
                         nn.Conv2d(32, 64, 3, 2, 1), nn.ReLU(),
                         nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                         nn.Linear(64, 10))
    model = Sequential()
    model.add(TorchNet.from_pytorch(conv, input_shape=(3, 64, 64)))
    model.compile(Adam(lr=1e-3), TorchCriterion(nn.MSELoss()))
    xs = rs.randn(TORCHNET_BATCH, 3, 64, 64).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rs.randint(0, 10, TORCHNET_BATCH)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(xs, ys, batch_size=TORCHNET_BATCH,
                     nb_epoch=TORCHNET_TRAIN_STEPS)
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {"fused_adam": TORCHNET_TRAIN_STEPS},
                    "22c TorchNet fit")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"22c TorchNet losses {losses}")
    print(f"22c a BatchNorm-free convnet TorchNet, TorchCriterion(MSELoss) "
          f"on one-hot targets, Adam(1e-3), batch {TORCHNET_BATCH} x "
          f"3x64x64, {TORCHNET_TRAIN_STEPS} steps in {fit_s:.3f} s: losses "
          f"{[round(l_, 5) for l_ in losses]}, launches {launches} ({card})")
    return launches


def wide_deep_bench_phase(torch, card, dev):
    """22d: the port's ``run_wide_deep_bench`` at its defaults."""
    from analytics_zoo_torch.benchmarks.wide_deep import run_wide_deep_bench
    from analytics_zoo_torch.ops import kernels
    kernels.reset_launch_counts()
    r = run_wide_deep_bench(dev)
    launches = kernels.launch_counts()
    steps = r["rows"] // r["batch_size"] * len(r["epoch_throughputs"])
    expect_launches(launches, {"fused_adam": steps}, "22d W&D bench")
    if not np.isfinite(r["value"]) or not r["train_accuracy"] > 0.5:
        fail(f"22d W&D bench {r}")
    print(f"22d run_wide_deep_bench at its defaults: "
          f"{json.dumps(r, sort_keys=True)}; launches {launches} ({card})")


def gan_phase(torch, card, dev):
    """22e: ``GANEstimator`` on Dense generator/discriminator, one D step
    card against CPU on the same noise (float32 products, SGD: Adam's first
    update is lr * g / (|g| + eps), a sign for all but the smallest
    gradients, so one ulp of a near-zero gradient moves a param by up to
    2 lr), then 20 alternating Adam steps; the TensorFlow-only parts named
    when TensorFlow does not import."""
    import importlib.util

    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_torch.ops import dtypes
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.tfpark.gan import GANEstimator

    def build(optim):
        Layer.reset_name_counters()
        g = Sequential()
        g.add(Dense(256, activation="relu", input_shape=(64,)))
        g.add(Dense(784, activation="tanh"))
        d = Sequential()
        d.add(Dense(256, activation="relu", input_shape=(784,)))
        d.add(Dense(1))
        est = GANEstimator(g, d, generator_optim_method=optim(),
                           discriminator_optim_method=optim())
        est._build(torch.Generator().manual_seed(7))
        return est
    rs = np.random.RandomState(6)
    real = np.tanh(rs.randn(64, 784)).astype(np.float32)
    noise = rs.randn(64, 64).astype(np.float32)

    def first_d_step(est, device):
        out = est._d_step(est.g_params, est.d_params, est.g_state,
                          est.d_state, est.d_opt_state,
                          torch.from_numpy(real).to(device),
                          torch.from_numpy(noise).to(device),
                          torch.Generator(device=device).manual_seed(0))
        return float(out[3]), [t.cpu().numpy()
                               for t in tree_leaves(out[0])]
    default = dtypes.get_policy()
    dtypes.set_policy("float32", "float32")
    sgd = lambda: SGD(0.05)  # noqa: E731
    card_loss, card_params = first_d_step(build(sgd), dev)
    with zoo_device("cpu"):
        cpu_loss, cpu_params = first_d_step(build(sgd), torch.device("cpu"))
    dtypes.restore_policy(default)
    err = max([abs(card_loss - cpu_loss)] + [
        float(np.abs(a - b).max()) for a, b in zip(card_params, cpu_params)])
    print(f"22e GANEstimator (Dense 64->256->784 / 784->256->1): first D "
          f"step (SGD(0.05), float32 products) card vs CPU on the same "
          f"noise: loss {card_loss:.6f} vs {cpu_loss:.6f}, max abs err over "
          f"loss and params {err:.3e} (tolerance {GAN_ATOL})")
    if not err <= GAN_ATOL:
        fail(f"22e GAN D step card and CPU differ: {err}")
    card_est = build(lambda: Adam(lr=2e-4))
    t0 = time.perf_counter()
    hist = card_est.train(real, noise_dim=64, batch_size=64,
                          steps=GAN_STEPS, rng=0)
    train_s = time.perf_counter() - t0
    flat = [v for h in hist for v in h.values()]
    if len(hist) != GAN_STEPS or not all(np.isfinite(flat)):
        fail(f"22e GAN history {hist}")
    print(f"22e GANEstimator.train (Adam(2e-4) both): {GAN_STEPS} "
          f"alternating D/G steps in "
          f"{train_s:.3f} s, d_loss {[round(h['d_loss'], 4) for h in hist]}, "
          f"g_loss {[round(h['g_loss'], 4) for h in hist]} ({card})")
    if importlib.util.find_spec("tensorflow") is None:
        print(f"22e not run here, for want of TensorFlow (tensorflow does not "
              f"import on this machine; tier-1 holds them to the reference "
              f"on the CPU): {', '.join(TF_ONLY)}")
    else:
        print(f"22e tensorflow imports here; the TensorFlow-only parts "
              f"({', '.join(TF_ONLY)}) are held to the reference by tier-1 "
              f"on the CPU, not by this script")


def interop_phase(torch, card, dev):
    """Phase 22: models from other frameworks.  Returns the SGD launches
    of 22a, the Adam launches of 22b, the kernels' errors and their times
    at Inception-v1's and ResNet-50 (ONNX)'s leaves."""
    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    t_phase = time.perf_counter()
    mark = len(CAPTURE_LOG)
    sgd_launches, inc_errs, inc_times = inception_tfpark(torch, card, dev)
    report_captures("22a", mark, card)
    mark = len(CAPTURE_LOG)
    adam_launches, onnx_errs, onnx_times = onnx_resnet50(torch, card, dev)
    report_captures("22b", mark, card)
    mark = len(CAPTURE_LOG)
    torchnet_phase(torch, card, dev)
    report_captures("22c", mark, card)
    mark = len(CAPTURE_LOG)
    wide_deep_bench_phase(torch, card, dev)
    report_captures("22d", mark, card)
    mark = len(CAPTURE_LOG)
    gan_phase(torch, card, dev)
    report_captures("22e", mark, card)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return sgd_launches, adam_launches, {
        k: max(inc_errs[k], onnx_errs[k]) for k in inc_errs}, inc_times, \
        onnx_times


def interop_alone() -> None:
    """Phase 22 by itself (``--interop``): the kernels built, then the
    models from other frameworks on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    interop_phase(torch, card, ctx.device)


# ------------------------------------------------------------- phase 23
# 23a: LocalEstimator on phase 2's BERT-base TextClassifier
LOCAL_ROWS, LOCAL_BATCH = 64, 8            # one epoch of 8 steps
LOCAL_TIMED = 10
LOCAL_CHECK_ROWS = 1          # card against CPU: 2 epochs of 1 step
LOCAL_LOSS_ATOL = 1e-4
LOCAL_PARAM_RTOL = 1e-5                    # of the params' largest magnitude
# The card-against-CPU steps take SGD: Adam's first updates are
# lr·g/(|g|+ε), which turn a gradient's last-bit difference into up to
# 2·lr at ε = 1e-8 (phase 22e), and still pass it through about 1:1 at
# ε = 1e-3, where the split-TF32 flash backward's differences (within
# 1e-4 + 1e-4 relative of the plain version's) summed over 1024 tokens
# moved a param by 1.846e-04 on an H100 while the losses agreed within
# 9.537e-07.  SGD moves a param by lr times the gradient's difference.
LOCAL_CHECK_LR = 0.01
# 23b: the watchdog drill on phase 17's AnomalyDetector
DRILL_NAN_ROWS = 10                        # the last rows' targets NaN
DRILL_MAX_STEPS = 200
# 23c: the storm on the fleet of BERT-base replicas
STORM_BASE_RATE, STORM_BURST_MULT = 20.0, 10.0
STORM_MIN_BURST_S = 20.0
STORM_UP_FACTOR = 1.6         # a loaded replica's start-up over an idle one's
STORM_P99_MS = 60_000.0
STORM_SCALE_UP_LAG_S = 10.0
# One captured BERT-base replica nearly keeps up with the 200 records/s
# burst: on an H100 its queue gauge read 0-23 through the burst and 67
# just after the broker outage, and a 1.2 s outage with a depth of 32
# scaled the fleet in three runs but not in a fourth, where the
# post-outage backlog fell under 32 within the sustain window.
# So the fleet scales on the outage's backlog: a 3 s outage (600 records
# queued) and a depth of two batches.
STORM_SCALE_UP_DEPTH = 16
STORM_OUTAGE_S = 3.0
STORM_DISTINCT_ROWS = 8
STORM_RESULT_TIMEOUT_S = 120.0


def time_local_steps(torch, le, x, y, dev, n):
    """``n`` timed steps of ``le``'s own step program (the one ``fit``
    replays) at ``LOCAL_BATCH``, each ended by a synchronize, after 2
    untimed; ms."""
    from analytics_zoo_torch.parallel.trainer import (
        put_on_device, step_generator)
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
    variables = le.model.get_variables()
    params = tree_map(lambda a: a.detach().clone(), variables["params"])
    state = tree_map(lambda a: a.detach().clone(), variables["state"])
    opt_state = le.optim.init(params)
    bx, by = put_on_device((x[:LOCAL_BATCH], y[:LOCAL_BATCH]), dev)
    step = le._current_step()
    ms = []
    for i in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, state, _, _ = step(
            params, opt_state, state, bx, by, step_generator(0, i, dev))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[2:]


def local_estimator_bert(torch, card, dev):
    """23a: ``LocalEstimator`` on phase 2's BERT-base ``TextClassifier``
    (8 x 512, Adam, the default policy): 8 steps through ``fit``, then
    ``evaluate`` and ``predict``; the launches a step; the step ms; two
    steps card against CPU under the float32 policy."""
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.ops.dtypes import (
        get_policy, restore_policy, set_policy)
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        to_device, tree_leaves, tree_map)
    from analytics_zoo_torch.pipeline.estimator import LocalEstimator
    Layer.reset_name_counters()
    model = bert_base()
    net = model.model
    net.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(23)
    x = rs.randint(0, 30522, size=(LOCAL_ROWS, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(LOCAL_ROWS,)).astype(np.int64)
    loss = "sparse_categorical_crossentropy_with_logits"
    le = LocalEstimator(net, loss, Adam(lr=1e-4), metrics=["accuracy"])
    steps = LOCAL_ROWS // LOCAL_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    le.fit(x, y, batch_size=LOCAL_BATCH, epochs=1, rng=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect_launches(launches, {
        "flash_attention_fwd": 12 * steps, "flash_attention_dq": 12 * steps,
        "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
        "layernorm_act": steps}, "23a LocalEstimator.fit")
    hist = le.history[-1]
    if not np.isfinite(hist["loss"]):
        fail(f"23a LocalEstimator loss {hist['loss']}")
    print(f"23a LocalEstimator.fit on BERT-base (8 x 512, Adam, the default "
          f"policy): {steps} steps in {fit_s:.3f} s (capture included), "
          f"loss {hist['loss']:.5f}; launches a step: "
          f"{ {k: v // steps for k, v in launches.items() if v} } "
          f"(fused_adam {launches['fused_adam']}: the optimizer's own "
          f"update) ({card})")
    ms = time_local_steps(torch, le, x, y, dev, LOCAL_TIMED)
    q = np.percentile(ms, [0, 25, 50, 75, 100])
    print(f"23a LocalEstimator step: median {q[2]:.3f} ms, quartiles "
          f"{q[1]:.3f}-{q[3]:.3f}, min {q[0]:.3f}, max {q[4]:.3f} over "
          f"{LOCAL_TIMED} captured steps of {LOCAL_BATCH} x 512, each ended "
          f"by a synchronize (the Estimator's captured step: 49.593-52.560 "
          f"ms in an earlier call) ({card})")
    t0 = time.perf_counter()
    scores = le.evaluate(x, y, batch_size=LOCAL_BATCH)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = le.predict(x, batch_size=LOCAL_BATCH)
    predict_s = time.perf_counter() - t0
    if logits.shape != (LOCAL_ROWS, 20) or not np.isfinite(logits).all() \
            or len(scores) != 1 or not all(0.0 <= v <= 1.0
                                           for v in scores.values()):
        fail(f"23a evaluate {scores}, predict {logits.shape}")
    print(f"23a evaluate {scores} in {eval_s:.3f} s, predict {logits.shape} "
          f"finite in {predict_s:.3f} s ({card})")

    # two steps card against CPU: float32 products, no dropout, SGD
    prior = get_policy()
    set_policy(param_dtype="float32", compute_dtype="float32")
    zero_dropout(net)
    start = tree_map(lambda a: a.detach().clone(), net.get_variables())
    xc, yc = x[:LOCAL_CHECK_ROWS], y[:LOCAL_CHECK_ROWS]
    runs = {}
    t_check = time.perf_counter()
    for where in ("card", "cpu"):
        net.set_variables(to_device(start, dev if where == "card"
                                    else torch.device("cpu")))
        with (zoo_device("cpu") if where == "cpu"
              else contextlib.nullcontext()):
            run = LocalEstimator(net, loss, SGD(LOCAL_CHECK_LR))
            run.fit(xc, yc, batch_size=LOCAL_CHECK_ROWS, epochs=2, rng=0)
        runs[where] = ([h["loss"] for h in run.history],
                       [a.detach().cpu() for a in tree_leaves(
                           net.get_variables()["params"])])
    restore_policy(prior)
    net.set_variables(to_device(start, dev))
    loss_diff = max(abs(a - b) for a, b in zip(runs["card"][0],
                                               runs["cpu"][0]))
    top = max(float(p.abs().max()) for p in runs["cpu"][1])
    diffs = [float((a - b).abs().max())
             for a, b in zip(runs["card"][1], runs["cpu"][1])]
    param_diff = max(diffs)
    worst = int(np.argmax(diffs))
    if not loss_diff <= LOCAL_LOSS_ATOL or \
            not param_diff <= LOCAL_PARAM_RTOL * top:
        fail(f"23a card against CPU: loss diff {loss_diff:.3e} (tolerance "
             f"{LOCAL_LOSS_ATOL}), params {param_diff:.3e} (tolerance "
             f"{LOCAL_PARAM_RTOL} x {top:.4f})")
    print(f"23a 2 LocalEstimator steps card against CPU (BERT-base, "
          f"{LOCAL_CHECK_ROWS} x 512, float32 policy, no dropout, "
          f"SGD({LOCAL_CHECK_LR})): losses {runs['card'][0]} vs "
          f"{runs['cpu'][0]}, max diff {loss_diff:.3e} (tolerance "
          f"{LOCAL_LOSS_ATOL}); params max abs diff {param_diff:.3e} (leaf "
          f"{worst} of {len(diffs)}) against {LOCAL_PARAM_RTOL} x {top:.4f}; "
          f"{time.perf_counter() - t_check:.1f} s ({card})")
    del le, net, model, runs, start
    torch.cuda.empty_cache()
    return launches, float(np.median(ms))


def _poisoned_step(x, y, batch):
    """The first step (0-based) of epoch 0 whose shuffled batch holds a
    NaN target, as the FeatureSet hands the batches out."""
    from analytics_zoo_torch.feature import FeatureSet
    for k, (_, by) in enumerate(FeatureSet.from_ndarrays(x, y)
                                .epoch_batches(0, batch, train=True)):
        if np.isnan(by).any():
            return k
    fail("23b: no batch holds the NaN targets")


def watchdog_drill(torch, card, dev, tmp):
    """23b: phase 17's AnomalyDetector trained through the Estimator
    under ``checkpoint_and_halt`` on targets NaN in the last rows, on the
    captured per-step route and the eager one; the halt snapshot in
    ``<model_dir>/halt/`` resumed under ``warn``; ``LocalEstimator`` on
    the same data halts; then the Adam kernel held and timed at the
    model's leaves.  Returns the drill's launches (the checks' are not
    counted), the Adam kernel's error and its times."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.common.triggers import MaxIteration
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.models.anomalydetection import unroll
    from analytics_zoo_torch.observability import (
        TrainingHalted, get_registry)
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.estimator import (
        Estimator, LocalEstimator)
    series, _ = taxi_like_series(TAXI_POINTS, seed=0)
    normed = (series - series.mean()) / (series.std() + 1e-8)
    x, y = unroll(normed, TAXI_UNROLL)
    y = y.copy()
    y[-DRILL_NAN_ROWS:] = np.nan
    poisoned = _poisoned_step(x, y, AD_BATCH)
    epoch_steps = len(x) // AD_BATCH
    cfg = get_config()
    halts = {}
    cfg.set("observability.watchdog_policy", "checkpoint_and_halt")
    try:
        for route, aot in (("captured", True), ("eager", False)):
            cfg.set("compile.aot", aot)
            model = anomaly_detector(torch)
            model_dir = os.path.join(tmp, f"drill-{route}")
            est = Estimator(model.model, optim_method=Adam(lr=0.01),
                            model_dir=model_dir)
            t0 = time.perf_counter()
            try:
                est.train(FeatureSet.from_ndarrays(x, y), "mse",
                          end_trigger=MaxIteration(DRILL_MAX_STEPS),
                          batch_size=AD_BATCH)
            except TrainingHalted as e:
                issue = e.issue
            else:
                fail(f"23b {route}: the Estimator trained on NaN targets "
                     "without a halt")
            halt_s = time.perf_counter() - t0
            halt = est.train_state.iteration
            halts[route] = halt
            # the first sync point at or after the poisoned step: the
            # health check after it, at the latest the epoch's loss read
            if issue.get("kind") != "nonfinite" or \
                    not poisoned + 1 <= halt <= epoch_steps:
                fail(f"23b {route}: halted at iteration {halt} on {issue}; "
                     f"the poisoned step is {poisoned}, the epoch's end "
                     f"{epoch_steps}")
            halt_dir = os.path.join(model_dir, "halt")
            snaps = sorted(os.listdir(halt_dir))
            if snaps != [f"snapshot.{halt}.ckpt"] or any(
                    n.startswith("snapshot.") for n in os.listdir(model_dir)):
                fail(f"23b {route}: halt snapshots {snaps}, model_dir "
                     f"{sorted(os.listdir(model_dir))}")
            print(f"23b watchdog drill, {route} route (AnomalyDetector, "
                  f"{len(x)} windows of {TAXI_UNROLL}, batch {AD_BATCH}, the "
                  f"last {DRILL_NAN_ROWS} targets NaN): the first poisoned "
                  f"batch is step {poisoned}; halted at iteration {halt} "
                  f"({issue}) in {halt_s:.3f} s, snapshot {halt_dir}/"
                  f"{snaps[0]} ({card})")
        cfg.set("compile.aot", True)
        # the halt snapshot resumes under warn
        cfg.set("observability.watchdog_policy", "warn")
        before = get_registry().counter("checkpoint_restore_total",
                                        "").value
        model = anomaly_detector(torch)
        est = Estimator(model.model, optim_method=Adam(lr=0.01),
                        model_dir=os.path.join(tmp, "drill-captured", "halt"))
        est.train(FeatureSet.from_ndarrays(x, y), "mse",
                  end_trigger=MaxIteration(halts["captured"] + 4),
                  batch_size=AD_BATCH)
        restored = get_registry().counter("checkpoint_restore_total",
                                          "").value - before
        if restored != 1 or \
                est.train_state.iteration != halts["captured"] + 4:
            fail(f"23b resume from the halt snapshot: {restored} restores, "
                 f"iteration {est.train_state.iteration}")
        print(f"23b a fresh Estimator on the halt directory restored "
              f"iteration {halts['captured']} and trained on to "
              f"{est.train_state.iteration} under warn ({card})")
        # LocalEstimator on the same poisoned data halts
        cfg.set("observability.watchdog_policy", "checkpoint_and_halt")
        model = anomaly_detector(torch)
        try:
            LocalEstimator(model.model, "mse", Adam(lr=0.01)).fit(
                x, y, batch_size=AD_BATCH, epochs=1)
        except TrainingHalted as e:
            print(f"23b LocalEstimator halted: {str(e)[:120]} ({card})")
        else:
            fail("23b LocalEstimator trained on NaN targets without a halt")
    finally:
        cfg.set("compile.aot", True)
        cfg.set("observability.watchdog_policy", "warn")
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    launches = kernels.launch_counts()
    # the Estimator's trainer takes the fused Adam update: the kernel held
    # and timed at the drill model's leaves
    leaves = tree_leaves(anomaly_detector(torch).get_variables()["params"])
    errs = opt_leaves_check(torch, leaves, "AnomalyDetector")
    times = time_updates(torch, leaves, card, "AnomalyDetector")
    return launches, errs["fused_adam"], times["fused_adam"]


def storm_config(tmp, weights, broker_url) -> str:
    """The replicas' ``config.yaml``: phase 15d's CLI builder over the
    phase's ``save_model`` file, batch 8 with buckets 1/2/4/8 at 512
    tokens, top 5, a consumer group, breakers that probe every 0.3 s."""
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        f.write("model:\n"
                "  builder: chip_smoke:bert_base\n"
                f"  weights: {weights}\n"
                "data:\n"
                f"  src: {broker_url}\n"
                "params:\n"
                "  batch_size: 8\n"
                "  top_n: 5\n"
                "  input_shape: 512\n"
                "  batch_buckets: 1,2,4,8\n"
                "  reclaim_min_idle_ms: 4000\n"
                "  breaker_cooldown_s: 0.3\n"
                "  metrics_host: 127.0.0.1\n")
    return path


class FleetWatch:
    """From a thread of its own: each replica incarnation's time from
    spawn to its first ``/healthz`` 200 (probed every 0.1 s), and every
    0.5 s the autoscaler's signal as the supervisor reads it, each live
    replica's ``/metrics.json`` (``signals``: storm-clock time, replica,
    fetch ms, ``serving_queue_depth``; the supervisor gives a fetch 1 s)."""

    def __init__(self, sup):
        import threading
        self.sup, self.ready, self.signals = sup, {}, []
        self.t0 = None          # the storm's start (time.monotonic)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _signal(self, r):
        from urllib import request as urlrequest
        t = time.monotonic()
        try:
            with urlrequest.urlopen(
                    f"http://127.0.0.1:{r.port}/metrics.json",
                    timeout=5.0) as resp:
                doc = json.loads(resp.read().decode())
            queue = doc.get("gauges", {}).get("serving_queue_depth")
        except Exception as e:   # noqa: BLE001 — recorded, not fatal
            queue = type(e).__name__
        self.signals.append((round(t - self.t0, 2), r.index,
                             round((time.monotonic() - t) * 1e3, 1), queue))

    def _run(self):
        last_signal = 0.0
        while not self._stop.is_set():
            sample = self.t0 is not None and \
                time.monotonic() - last_signal >= 0.5
            if sample:
                last_signal = time.monotonic()
            for r in self.sup._fleet():
                key = (r.index, r.incarnation)
                if r.proc is None:
                    continue
                if key not in self.ready:
                    try:
                        ok = self.sup._probe(r) == "ok"
                    except Exception as e:   # noqa: BLE001 — retried
                        print(f"23c fleet watch: probe of replica "
                              f"{r.index} raised {type(e).__name__}: {e}")
                        ok = False
                    if ok:
                        self.ready[key] = self.sup._clock() - r.spawned_at
                elif sample and r.port is not None:
                    self._signal(r)
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()
        self._thread.join(10)


def top_agrees(result, probs, tol=PROB_ATOL) -> bool:
    """A served top-N against the in-process probabilities of the same
    row: every class's probability within ``tol``, and the classes the
    in-process top N up to ties within ``tol``."""
    n = len(result)
    nth = np.sort(probs)[-n]
    return n == min(5, len(probs)) and \
        len({c for c, _ in result}) == n and \
        all(abs(p - probs[c]) <= tol and probs[c] >= nth - tol
            for c, p in result)


def fleet_storm(torch, card, dev, tmp):
    """23c: a supervised, autoscaled fleet (1 to 2) of BERT-base replicas,
    each ``cli_worker_factory``'s ``serving.cli start`` over the phase's
    ``save_model`` file, stormed by ``flash_burst_with_outage`` at 20
    records/s and a 10x burst, with a real broker outage and replica 0
    SIGKILLed mid-burst; then seeded distinct rows; then the SIGTERM
    drain.  Returns the run dir, the run and the scenario."""
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.serving import cli as serving_cli
    from analytics_zoo_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_torch.serving.loadgen import (
        SCENARIOS, PayloadFactory, ScenarioEvent, SloSpec, evaluate,
        fleet_snapshot, pending_count, read_dead_letters, run_scenario)
    from analytics_zoo_torch.serving.redis_client import (
        BrokerServer, EmbeddedBroker, connect)
    from analytics_zoo_torch.serving.supervisor import (
        ServingSupervisor, cli_worker_factory)
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer

    # one weights file: every replica serves the same model
    Layer.reset_name_counters()
    model = bert_base()
    model.model.init(torch.Generator().manual_seed(0))
    weights = os.path.join(tmp, "bert_base.model")
    model.save_model(weights)
    del model
    Layer.reset_name_counters()
    im = InferenceModel().load_zoo(serving_cli._build_model(
        "chip_smoke:bert_base", weights=weights))

    srv = BrokerServer(EmbeddedBroker(), host="127.0.0.1")
    port = srv.port
    holder = {"srv": srv, "windows": []}
    run_dir = os.path.join(tmp, "fleet")
    os.makedirs(run_dir)
    config = storm_config(tmp, weights, srv.url)
    base = cli_worker_factory(config, consumer_group="serve")

    def factory(index, incarnation):
        cmd, env = base(index, incarnation)
        # the replica joins the run dir's observability plane
        return cmd, {**env, "ZOO_TPU_RUN_DIR": run_dir}

    sup = ServingSupervisor(
        factory, replicas=1, min_replicas=1, max_replicas=2,
        scale_up_queue_depth=STORM_SCALE_UP_DEPTH, scale_up_sustain_s=1.0,
        scale_down_idle_s=3600.0, scale_cooldown_s=5.0,
        autoscale_interval_s=0.5, health_interval_s=1.0,
        startup_grace_s=180.0, retry_times=3, retry_window_s=600.0,
        backoff_base_s=0.5, backoff_max_s=2.0, run_dir=run_dir,
        drain_timeout_s=90.0)
    watch = FleetWatch(sup)
    t_sup = sup.run_background()
    if not sup.wait_ready(timeout_s=240.0):
        fail(f"23c: the first replica never answered /healthz 200: "
             f"{sup.summary()}")
    # the watch's own probe may still be in flight: then the time from
    # the spawn to wait_ready's 200 (at most one 0.1 s poll late)
    startup_s = watch.ready.get(
        (0, 1), sup._clock() - sup._fleet()[0].spawned_at)
    # the second replica spawns once the outage's backlog has held for
    # the sustain window and the autoscaler's poll (~3 s after the
    # outage ends) and starts slower than the first beside a serving
    # replica and the storm's own threads (22.145 s against 14.602 idle,
    # measured on an H100): the burst outlasts that by 8 s, and replica 0
    # dies 2 s after it
    up_s = STORM_UP_FACTOR * startup_s + 1.0 + STORM_OUTAGE_S + 3.0
    burst_s = max(STORM_MIN_BURST_S, float(np.ceil(up_s)) + 8.0)
    scenario = SCENARIOS["flash_burst_with_outage"](
        base_rate=STORM_BASE_RATE, burst_mult=STORM_BURST_MULT,
        burst_s=burst_s, outage_s=STORM_OUTAGE_S, poison=0,
        slo=SloSpec(p99_from_scheduled_ms=STORM_P99_MS,
                    scale_up_lag_s=STORM_SCALE_UP_LAG_S))
    burst_start, burst_end = scenario.phase_window("burst")
    kill_at = burst_start + up_s + 2.0
    scenario.events = sorted(
        scenario.events + [ScenarioEvent(at_s=kill_at, kind="kill_replica")],
        key=lambda e: e.at_s)
    killed = []

    def outage(event, edge):
        # a real outage: the TCP listener stops, then comes back on the
        # same port over the same broker state
        if edge == "start":
            holder["windows"].append(time.monotonic())
            holder["srv"].stop()
        else:
            holder["srv"] = BrokerServer(broker=holder["srv"].broker,
                                         host="127.0.0.1", port=port)

    def kill_replica(event, edge):
        r = sup._fleet()[0]
        if r.proc is None or r.proc.poll() is not None:
            fail("23c: replica 0 is not running at the kill event")
        killed.append((r.incarnation, time.monotonic()))
        r.proc.kill()

    print(f"23c fleet: replica 0 ready {startup_s:.3f} s after its spawn "
          f"(process start, CUDA, BERT-base weights, kernel libraries, 4 "
          f"buckets captured); storm flash_burst_with_outage at "
          f"{STORM_BASE_RATE:g} records/s, burst x{STORM_BURST_MULT:g} for "
          f"{burst_s:g} s, broker outage {burst_start + 1.0:g}-"
          f"{burst_start + 1.0 + STORM_OUTAGE_S:g} s, replica 0 SIGKILLed at "
          f"{kill_at:.1f} s ({card})")
    t0 = time.perf_counter()
    watch.t0 = time.monotonic()
    run = run_scenario(
        scenario, compress=1.0,
        hooks={"broker_outage": outage, "kill_replica": kill_replica},
        broker_factory=lambda: connect(f"127.0.0.1:{port}"),
        payloads=PayloadFactory(shape=(512,)),
        result_timeout_s=STORM_RESULT_TIMEOUT_S, send_retry_s=10.0)
    storm_s = time.perf_counter() - t0
    broker = holder["srv"].broker
    deadline = time.monotonic() + 60.0
    while pending_count(broker, group="serve") and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    pending = pending_count(broker, group="serve")
    verdict = evaluate(run, scenario.slo, fleet=fleet_snapshot(sup),
                       dead_letters=read_dead_letters(broker),
                       pending=pending, burst_start_offset_s=burst_start)
    print(f"23c storm: {len(run.records)} records in {storm_s:.1f} s, "
          f"outcomes {run.counts()} ({card})")
    slow = [x for x in watch.signals if x[2] > 1000.0
            or isinstance(x[3], str)]
    print(f"23c the autoscaler's signal, each replica's /metrics.json "
          f"every 0.5 s (storm s, replica, fetch ms, queue depth): "
          f"{len(watch.signals)} reads, {len(slow)} over the supervisor's "
          f"1 s or failed {slow[:12]}; every 4th "
          f"{watch.signals[::4][:60]} ({card})")
    print("23c verdict:\n" + verdict.render())
    if not verdict.passed:
        fail("23c: the storm's verdict failed")
    for name in ("exactly_once", "scale_up_lag", "no_flap",
                 "p99_from_scheduled"):
        if verdict.check(name).skipped:
            fail(f"23c: the verdict skipped {name}")
    cap = verdict.capacity or {}
    print(f"23c capacity: {cap.get('rps_per_replica_at_slo')} records/s a "
          f"replica at p99 <= {STORM_P99_MS:g} ms; replicas for "
          f"{cap.get('replicas_for')} ({card})")
    if len(holder["windows"]) != 1 or len(killed) != 1:
        fail(f"23c: outage windows {len(holder['windows'])}, kills {killed}")

    # every ok result is in-process predict's on the same row
    zeros = np.zeros((1, 512), np.float32)
    logits = im.predict(zeros, batch_size=1)[0]
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    conn = connect(f"127.0.0.1:{port}")
    checked = 0
    for r in run.records:
        if r.status != "ok":
            continue
        fields = conn.hgetall("result:" + r.spec.uri)
        raw = fields.get("value", fields.get(b"value"))
        doc = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        if not top_agrees(doc, probs):
            fail(f"23c: {r.spec.uri}'s result {doc} is not in-process "
                 f"predict's top 5 {np.argsort(-probs)[:5].tolist()}")
        checked += 1
    # then, with every replica back (replica 0's second incarnation
    # included), seeded distinct rows through the fleet
    if not sup.wait_ready(timeout_s=240.0):
        fail(f"23c: the fleet is not ready after the storm: "
             f"{sup.summary()}")
    rows = np.random.RandomState(230).randint(
        0, 30522, size=(STORM_DISTINCT_ROWS, 512)).astype(np.int64)
    inq, outq = InputQueue(srv.url), OutputQueue(srv.url)
    for i, row in enumerate(rows):
        inq.enqueue(f"distinct-{i}", row)
    want = im.predict(rows, batch_size=8)
    for i in range(STORM_DISTINCT_ROWS):
        got = outq.query(f"distinct-{i}", timeout_s=60.0)
        p = np.exp(want[i] - want[i].max())
        if got is None or not top_agrees(got, p / p.sum()):
            fail(f"23c: distinct row {i} served {got}")
    print(f"23c results: {checked} ok records' top 5 and "
          f"{STORM_DISTINCT_ROWS} seeded distinct rows' equal in-process "
          f"InferenceModel.predict's on the same rows (probabilities "
          f"within {PROB_ATOL}) ({card})")

    # the SIGTERM drain
    t0 = time.perf_counter()
    sup.stop()
    t_sup.join(120)
    watch.stop()
    drain_s = time.perf_counter() - t0
    summary = sup.summary()
    pending = pending_count(broker, group="serve")
    holder["srv"].stop()
    if t_sup.is_alive() or summary["degraded"] or pending or any(
            code != 0 for code in summary["exit_codes"].values()):
        fail(f"23c drain: {summary}, pending {pending}")
    ready = {f"replica {i} incarnation {n}": round(s, 3)
             for (i, n), s in sorted(watch.ready.items())}
    print(f"23c fleet: replica_trajectory "
          f"{[(round(t - run.started_wall, 2), n, why) for t, n, why in sup.replica_trajectory]} "
          f"(seconds from the storm's start), scale events "
          f"{[(e['direction'], e['replica']) for e in sup.scale_events]}, "
          f"restarts {sup.restarts_total}; spawn to first /healthz 200: "
          f"{ready}; the SIGTERM drain in {drain_s:.3f} s, exit codes "
          f"{summary['exit_codes']}, pending 0 ({card})")
    if len(watch.ready) < 3 or sup.restarts_total < 1 or \
            max(n for _t, n, _w in sup.replica_trajectory) < 2:
        fail("23c: the fleet did not scale up, restart and serve with "
             f"every incarnation: ready {ready}")
    # the second replica served inside the burst
    up_at = next(t for t, n, why in sup.replica_trajectory
                 if why == "scale_up") - run.started_wall
    if (1, 1) not in watch.ready:
        fail(f"23c: the second replica never answered /healthz 200: {ready}")
    serving_at = up_at + watch.ready[(1, 1)]
    print(f"23c the second replica: spawned {up_at:.2f} s into the storm, "
          f"ready at {serving_at:.2f} s; the burst runs {burst_start:g}-"
          f"{burst_end:g} s ({card})")
    if not serving_at < burst_end:
        fail("23c: the second replica came up after the burst")
    del im
    torch.cuda.empty_cache()
    return run_dir, run, scenario


def fleet_tools(card, run_dir, run):
    """23d: the offline tools over 23c's run dir, each beside its inputs:
    the aggregator, the SLO timeline, drift, and the incident
    diagnosis."""
    from analytics_zoo_torch.observability import (
        ClusterAggregator, drift_report, evaluate_timeline, load_slo_yaml,
        merge_requests, merge_traces, straggler_report, write_incident)
    from analytics_zoo_torch.observability.tsdb import SeriesStore
    from analytics_zoo_torch.serving.loadgen import run_series_store
    agg = ClusterAggregator.from_run_dir(run_dir, offline=True)
    host_snaps, merged = agg.cluster_view()
    if len(host_snaps) < 2:
        fail(f"23d: {len(host_snaps)} host slots merged, want 2")
    served = sum(v for k, v in merged["counters"].items()
                 if k.startswith("serving_records_total"))
    rep = straggler_report(host_snaps)
    traces = merge_traces(run_dir, os.path.join(run_dir, "trace.merged.json"))
    reqs = merge_requests(run_dir,
                          os.path.join(run_dir, "requests.merged.json"))
    print(f"23d aggregator: {len(host_snaps)} hosts {sorted(host_snaps)}, "
          f"serving_records_total {served:g} (the last incarnations' "
          f"counts), straggler {rep.get('straggler')}; merge_traces "
          f"{traces['otherData']['hosts_merged']} hosts, "
          f"{len(traces['traceEvents'])} events; merge_requests "
          f"{reqs['hosts_merged']} hosts, {len(reqs['timelines'])} "
          f"timelines ({card})")
    objectives = [o.scaled(0.005) for o in load_slo_yaml(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "slo.yaml"))]
    timeline = evaluate_timeline(run_series_store(run), objectives)
    alerts = {o.name: Counter(row[i].alert for row in timeline)
              for i, o in enumerate(objectives)}
    print(f"23d SLO timeline (slo.yaml, windows x0.005) over "
          f"{len(timeline)} points: alerts "
          f"{ {k: dict(v) for k, v in alerts.items()} }; final budgets "
          f"{ {st.name: round(st.budget_remaining, 4) for st in timeline[-1]} }")
    lat = sorted((run.wall_of(r.done), r.latency_from_scheduled_s)
                 for r in run.records if r.done is not None)
    store = SeriesStore([{"t": t, "counters": {},
                          "gauges": {"loadgen_latency_seconds": v}}
                         for t, v in lat])
    drift = drift_report(store, ["loadgen_latency_seconds"])
    print(f"23d drift over the latency series ({len(lat)} points): {drift}")
    tsdb_points = len(SeriesStore.from_run_dir(run_dir).samples)
    doc, path = write_incident(run_dir)
    ranks = [(h["cause"], h["confidence"]) for h in doc["hypotheses"]]
    outage = next((h for h in doc["hypotheses"]
                   if h["cause"] == "broker_outage"), None)
    if outage is None or not any(
            "breaker opened" in (e.get("note") or "")
            for e in outage["evidence"]):
        fail(f"23d: diagnose did not rank the broker outage with its "
             f"breaker-open citations: {ranks}")
    print(f"23d diagnose -> {path}: root cause {doc['root_cause']}, "
          f"ranking {ranks}; broker_outage rank {outage['rank']} citing "
          f"{[e['ref'] for e in outage['evidence']]}; {tsdb_points} TSDB "
          f"samples in the replicas' slots")


def quick_start_card(torch, card, dev):
    """23e: ``quick_start.main(["--smoke"])`` in this process, on the
    live context's card."""
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    from analytics_zoo_torch.serving import quick_start
    t0 = time.perf_counter()
    result = quick_start.main(["--smoke"])
    dt = time.perf_counter() - t0
    if not result or get_zoo_context().device != dev or dev.type != "cuda":
        fail(f"23e quick_start: {result} on {get_zoo_context().device}")
    print(f"23e quick_start --smoke on {get_zoo_context().device}: "
          f"{result} in {dt:.3f} s ({card})")


def fleet_phase(torch, card, dev):
    """Phase 23: the local trainer and the serving fleet.  Returns the
    launches of the whole phase in this process (the replicas are
    processes of their own; the optimizer checks' launches are not
    counted), 23a's median step ms, and the Adam kernel's error and
    times at 23b's leaves."""
    import shutil
    import tempfile

    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    from analytics_zoo_torch.ops import kernels
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zoo-phase23-")
    total = Counter()
    kernels.reset_launch_counts()
    secs = {}
    try:
        mark, t0 = len(CAPTURE_LOG), time.perf_counter()
        local_launches, step_ms = local_estimator_bert(torch, card, dev)
        total.update(kernels.launch_counts())
        report_captures("23a", mark, card)
        mark, secs["23a"] = len(CAPTURE_LOG), time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        drill_launches, adam_err, adam_times = watchdog_drill(
            torch, card, dev, tmp)
        total.update(drill_launches)
        report_captures("23b", mark, card)
        mark, secs["23b"] = len(CAPTURE_LOG), time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        run_dir, run, _ = fleet_storm(torch, card, dev, tmp)
        report_captures("23c", mark, card)
        secs["23c"], t0 = time.perf_counter() - t0, time.perf_counter()
        fleet_tools(card, run_dir, run)
        secs["23d"], t0 = time.perf_counter() - t0, time.perf_counter()
        quick_start_card(torch, card, dev)
        secs["23e"] = time.perf_counter() - t0
        total.update(kernels.launch_counts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: total.get(name, 0) for name in kernels.SIGNATURES}
    print(f"launches: phase 23 in this process {launches} (23a "
          f"LocalEstimator.fit 8 steps {local_launches}; 23b the drill "
          f"{drill_launches}); the replicas are processes of their own")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in secs.items()} } ({card})")
    return launches, step_ms, adam_err, adam_times


def fleet_alone() -> None:
    """Phase 23 by itself (``--fleet``): the kernels built, then the
    local trainer and the serving fleet on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    fleet_phase(torch, card, ctx.device)


# ------------------------------------------------------ 24. multi-GPU
MG_ROWS, MG_BATCH = 64, 8          # 24a: one epoch of 8 steps of 8 x 512
MG_SGD_STEPS = 2                   # 24b: SGD steps in each mesh
MG_SGD_LR = 1e-3
MG_SHAPES = ({"data": 2}, {"fsdp": 2}, {"model": 2})
MG_TIMEOUT = 600
# 24b against the one-device run over the same 8 rows, float32 products:
# the ranks' means of 4-row means, the row-parallel sums and the reduced
# gradients add in another order than one device (~1e-7 relative of a
# result), which two SGD steps carry into the params
MG_PARAM_RTOL = 1e-5               # of each leaf's largest magnitude
# 24b against the one-device run through the plain versions
# (ops.fused=torch): the routes' gradients differ by the flash kernels'
# split-TF32 products and LayerNorm's order of summation, which phase 3
# bounds at GRAD_RTOL_F32 of a leaf's gradient.  Two SGD steps move a
# leaf by lr times the sum of its gradients, so the params differ by that
# share of their update on top of MG_PARAM_RTOL of their magnitude: a
# zero-initialised bias holds nothing but its update (1.888e-05 of a
# leaf's magnitude on an H100 at 700 W, 0.019 of this bound), and a leaf
# whose update is a thousandth of its size differs by its float32 rounding
MG_PLAIN_UPDATE_RTOL = GRAD_RTOL_F32  # of each leaf's largest update
MG_LOSS_RTOL = 1e-5
MG_CHILD = "--multi-gpu-child"


def mg_data():
    rs = np.random.RandomState(24)
    x = rs.randint(0, 30522, size=(MG_ROWS, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(MG_ROWS,)).astype(np.int64)
    return x, y


def mg_net(torch, mesh=None):
    """Phase 3's BERT-base ``TextClassifier`` (seeded 0), its layers built
    on ``mesh`` (the tensor-parallel layers declare their pieces there)."""
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    Layer.reset_name_counters()
    net = bert_base().model
    with (mesh_lib.active(mesh) if mesh is not None
          else contextlib.nullcontext()):
        net.init(torch.Generator().manual_seed(0))
    return net


def mg_flat(tree) -> dict:
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    return {str(i): a.detach().cpu() for i, a in
            enumerate(tree_leaves(tree))}


def mg_digest(tree) -> str:
    """SHA-256 of a tree's leaves' bytes, in ``tree_leaves`` order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for a in mg_flat(tree).values():
        h.update(a.contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def mg_adam_run(torch):
    """24a's steps: ``Estimator.train``, 8 Adam steps of 8 x 512 on the
    context's mesh, deterministic algorithms on (the embeddings'
    ``index_add_``); (whole params, loss, launches)."""
    from analytics_zoo_torch.common.triggers import MaxEpoch
    from analytics_zoo_torch.feature.feature_set import FeatureSet
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.estimator import Estimator
    net = mg_net(torch)
    x, y = mg_data()
    est = Estimator(net, optim_method=Adam(lr=1e-4))
    kernels.reset_launch_counts()
    with deterministic(torch):
        est.train(FeatureSet.from_ndarrays(x, y, shuffle=False),
                  "sparse_categorical_crossentropy_with_logits",
                  end_trigger=MaxEpoch(1), batch_size=MG_BATCH, rng=0)
    torch.cuda.synchronize()
    return (mg_flat(est.variables["params"]), est.history[-1]["loss"],
            kernels.launch_counts())


# the kernel wrappers 24b's steps launch, each beside its plain version:
# (module attribute, plain version's attribute, launch-count name, the
# tolerances of its outputs as (atol, rtol), those of phase 2)
MG_KERNELS = (
    ("flash_attention_fwd", "flash_attention_ref", "flash_attention_fwd",
     ((FWD_ATOL, FWD_RTOL), (FWD_LSE_ATOL, 0.0))),
    ("flash_attention_dq", "flash_attention_dq_ref", "flash_attention_dq",
     ((BWD_ATOL, BWD_RTOL),)),
    ("flash_attention_dkv", "flash_attention_dkv_ref", "flash_attention_dkv",
     ((BWD_ATOL, BWD_RTOL), (BWD_ATOL, BWD_RTOL))),
    ("bias_gelu_kernel", "bias_gelu_ref", "bias_gelu", ((1e-6, 0.0),)),
    ("layernorm_act_kernel", "layernorm_act_ref", "layernorm_act",
     ((1e-5, 0.0),)),
)


def mg_kernel_checks(torch, calls, leaves, what):
    """Each kernel the steps launched against its plain version on the
    inputs of its first launch there (this rank's shapes: 6 heads and
    1,536 FFN columns a rank under ``model=2``), and the multi-tensor
    Adam and SGD (momentum 0, as the steps) on this rank's own table of
    pieces; {kernel: max abs err}."""
    errs = {}
    with torch.no_grad():
        for name, (kernel, plain, tols, args, kwargs) in calls.items():
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            errs[name] = max(
                close(f"{what} {name} {tuple(args[0].shape)} output {i}", g,
                      w, atol, rtol)
                for i, (g, w, (atol, rtol)) in enumerate(zip(got, want,
                                                             tols)))
    errs.update(opt_leaves_check(torch, leaves, what, sgd_momentum=0))
    return errs


def mg_sgd_steps(torch, mesh, rows, check=False):
    """24b's steps on ``mesh``: ``MG_SGD_STEPS`` SGD steps of the trainer
    over ``rows`` of the data (this rank's), float32 products; the
    gathered params' digest and loss after each step, the step and
    gradient-sync times, the launches and the whole params.  With
    ``check``, each kernel is then held against its plain version on the
    inputs of its first launch and on this rank's pieces
    (``mg_kernel_checks``)."""
    from analytics_zoo_torch.ops import fused, kernels
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    net = mg_net(torch, mesh)
    x, y = mg_data()
    trainer = DistributedTrainer(
        net, objectives.get("sparse_categorical_crossentropy_with_logits"),
        optim_method=SGD(MG_SGD_LR), mesh=mesh)
    params = trainer.place_params(net.get_variables()["params"])
    state = trainer.place_state(net.get_variables()["state"])
    opt_state = trainer.init_opt_state(params)
    batch = trainer.put_batch((x[rows], y[rows]))
    # the first sharded leaves: (this rank's piece, the axis)
    pieces = [(tuple(p.shape), sp.axis) for p, sp in zip(
        tree_leaves(params), trainer._flat_specs) if sp is not None][:3]
    sync_ms, heads = [], set()
    sync = trainer._sync_grads

    def timed_sync(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync(grads)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    trainer._sync_grads = timed_sync
    # every wrapper records the inputs of its first launch, and the
    # forward the heads of every launch
    calls, originals = {}, []
    for attr, plain_attr, name, tols in MG_KERNELS:
        mod = fa if attr.startswith("flash") else fused
        kernel = getattr(mod, attr)
        originals.append((mod, attr, kernel))

        def seen(*args, _k=kernel, _name=name, _plain=getattr(mod, plain_attr),
                 _tols=tols, **kwargs):
            if _name == "flash_attention_fwd":
                heads.add(int(args[0].shape[1]))
            if check and _name not in calls:
                calls[_name] = (_k, _plain, _tols, [
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args], kwargs)
            return _k(*args, **kwargs)
        setattr(mod, attr, seen)
    digests, losses, step_ms = [], [], []
    kernels.reset_launch_counts()
    try:
        for i in range(MG_SGD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, state, loss = trainer.train_step_at(
                params, opt_state, state, batch, 0, i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            whole = trainer.gather_tree(params)
            digests.append(mg_digest(whole))
            losses.append(float(loss))
    finally:
        for mod, attr, kernel in originals:
            setattr(mod, attr, kernel)
    launches = kernels.launch_counts()
    missed = [n for _, _, n, _ in MG_KERNELS if check and launches[n] and
              n not in calls]
    if missed:
        fail(f"24b {mesh.shape}: {missed} launched but no input recorded")
    errs = mg_kernel_checks(
        torch, calls, tree_leaves(params),
        f"24b {mesh.shape} rank {mesh.rank}") if check else {}
    return {"digests": digests, "losses": losses, "step_ms": step_ms,
            "sync_ms": sync_ms, "launches": launches,
            "heads": sorted(heads), "whole": mg_flat(whole),
            "pieces": pieces, "errs": errs,
            "checked": {n: tuple(c[3][0].shape) for n, c in calls.items()}}


def multi_gpu_child(part: str, out_dir: str) -> None:
    """A rank of 24a (``a``: a world of one over NCCL) or 24b (``b``: two
    ranks on the one card over gloo), started by ``launch_cli``."""
    import torch
    from analytics_zoo_torch.common import zoo_context as zc
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel import comm
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    kernels.build_all()
    t0 = time.perf_counter()
    if part == "a":
        # launch_cli -n 1: the group of one joined explicitly (the
        # context joins a group only for more than one process)
        zc.init_process_group(os.environ["ZOO_TPU_COORDINATOR"], 1, 0,
                              torch.device("cuda:0"))
        ctx = zc.init_zoo_context(device="cuda:0")
        import torch.distributed as dist
        backend, world = dist.get_backend(), dist.get_world_size()
        whole, loss, launches = mg_adam_run(torch)
        torch.save({"whole": whole, "loss": loss, "launches": launches,
                    "backend": backend, "world": world,
                    "mesh": ctx.mesh.shape,
                    "join_s": time.perf_counter() - t0},
                   os.path.join(out_dir, "a.pt"))
        return
    # two ranks on one card: NCCL refuses them, so they join a gloo group
    # themselves and the context keeps it
    from analytics_zoo_torch.common.config import get_config
    get_config().set("parallel.timeout_s", MG_TIMEOUT)
    zc.init_process_group(os.environ["ZOO_TPU_COORDINATOR"],
                          int(os.environ["ZOO_TPU_NUM_PROCESSES"]),
                          int(os.environ["ZOO_TPU_PROCESS_ID"]),
                          torch.device("cuda:0"), backend="gloo")
    ctx = zc.init_zoo_context(device="cuda:0")
    from analytics_zoo_torch.ops import dtypes
    dtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    rank = ctx.process_index
    ref = torch.load(os.path.join(out_dir, "ref_sgd.pt"))
    x, _ = mg_data()
    out = {"rank": rank, "modes": {}}
    comm.reset_collective_log()
    for shape in MG_SHAPES:
        mesh = mesh_lib.create_mesh(shape)
        split = mesh_lib.data_split_across_hosts(mesh)
        rows = slice(rank * MG_BATCH // 2, (rank + 1) * MG_BATCH // 2) \
            if split else slice(0, MG_BATCH)
        r = mg_sgd_steps(torch, mesh, rows, check=True)
        # the params against the one-device runs: through the kernels,
        # within MG_PARAM_RTOL of each leaf's magnitude; through the plain
        # versions, the largest share of each leaf's bound there
        r["max_rel_err_kernels"] = max(
            float((r["whole"][k] - ref["kernels"][k]).abs().max()) /
            max(float(ref["kernels"][k].abs().max()), 1e-30)
            for k in ref["kernels"])
        r["plain_share"] = max(
            float((r["whole"][k] - ref["plain"][k]).abs().max()) / max(
                MG_PARAM_RTOL * float(ref["plain"][k].abs().max()) +
                MG_PLAIN_UPDATE_RTOL * float(
                    (ref["plain"][k] - ref["init"][k]).abs().max()), 1e-30)
            for k in ref["plain"])
        del r["whole"]
        out["modes"][json.dumps(shape)] = r
    out["collectives"] = {op: sorted(w) for op, w in
                          comm.COLLECTIVE_LOG.items()}
    torch.save(out, os.path.join(out_dir, f"b{rank}.pt"))


def mg_launch(part: str, n: int, out_dir: str) -> float:
    """``launch_cli -n n chip_smoke.py --multi-gpu-child part out_dir``;
    the command's seconds (fails on a non-zero exit)."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "analytics_zoo_torch.parallel.launch_cli",
           "-n", str(n), "--timeout", str(MG_TIMEOUT),
           os.path.abspath(__file__), MG_CHILD, part, out_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=MG_TIMEOUT + 60)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-8000:])
        fail(f"24{part}: launch_cli exited {proc.returncode}")
    return time.perf_counter() - t0


def multi_gpu_phase(torch, card, dev):
    """Phase 24: the multi-GPU path on the one card.  Returns 24a's
    launches (the NCCL world of one), 24b rank 0's (SGD), the largest
    error of each kernel held against its plain version on the ranks'
    inputs and pieces and on BERT-base's whole leaves, and the Adam and
    SGD (momentum 0) updates' times over those leaves."""
    import shutil
    import tempfile

    from analytics_zoo_torch.ops import dtypes
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.mesh import trivial_mesh
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zoo-phase24-")
    try:
        # the same steps with no process group: 24a's control
        t0 = time.perf_counter()
        whole, loss, launches = mg_adam_run(torch)
        steps = MG_ROWS // MG_BATCH
        expect_launches(launches, {
            "flash_attention_fwd": 12 * steps,
            "flash_attention_dq": 12 * steps,
            "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
            "layernorm_act": steps, "fused_adam": steps},
            "24a control (no process group)")
        control_s = time.perf_counter() - t0
        # 24b's one-device controls: the same SGD steps over the 8 rows,
        # through the kernels and through the plain versions
        prior = dtypes.get_policy()
        dtypes.set_policy(param_dtype="float32", compute_dtype="float32")
        try:
            ref = mg_sgd_steps(torch, trivial_mesh(), slice(0, MG_BATCH))
            kernels.reset_launch_counts()
            plain = plain_route(lambda: mg_sgd_steps(
                torch, trivial_mesh(), slice(0, MG_BATCH)))
        finally:
            dtypes.restore_policy(prior)
        if any(kernels.launch_counts().values()):
            fail(f"24b's plain control launched kernels "
                 f"{kernels.launch_counts()}")
        refs = {"kernels": ref["losses"], "plain": plain["losses"]}
        torch.save({"kernels": ref["whole"], "plain": plain["whole"],
                    "init": mg_flat(mg_net(torch).get_variables()["params"])},
                   os.path.join(tmp, "ref_sgd.pt"))
        del plain
        torch.cuda.empty_cache()

        # ---- 24a: a world of one over NCCL, started through launch_cli
        a_s = mg_launch("a", 1, tmp)
        a = torch.load(os.path.join(tmp, "a.pt"))
        expect_launches(a["launches"], {
            "flash_attention_fwd": 12 * steps,
            "flash_attention_dq": 12 * steps,
            "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
            "layernorm_act": steps, "fused_adam": steps},
            "24a Estimator.train on the NCCL world of one")
        differ = [k for k in whole if not torch.equal(whole[k],
                                                      a["whole"][k])]
        if a["backend"] != "nccl" or a["world"] != 1 or differ or \
                a["loss"] != loss:
            fail(f"24a: backend {a['backend']} world {a['world']}, loss "
                 f"{a['loss']} vs {loss} with no group, {len(differ)} of "
                 f"{len(whole)} leaves differ")
        print(f"24a Estimator.train through launch_cli on an NCCL world of "
              f"one, mesh {a['mesh']}: {steps} Adam steps of {MG_BATCH} x "
              f"512 bit-identical to the same steps with no process group "
              f"({len(whole)} leaves, loss {loss:.6f}); launches a step "
              f"{ {k: v // steps for k, v in a['launches'].items() if v} }; "
              f"the child's command {a_s:.1f} s ({card})")

        # ---- 24b: two ranks on the one card over gloo, CUDA tensors
        b_s = mg_launch("b", 2, tmp)
        ranks = [torch.load(os.path.join(tmp, f"b{r}.pt")) for r in (0, 1)]
        for shape in MG_SHAPES:
            key = json.dumps(shape)
            r0, r1 = (r["modes"][key] for r in ranks)
            if r0["digests"] != r1["digests"]:
                fail(f"24b {shape}: the ranks' params differ after a step")
            for r, m in ((0, r0), (1, r1)):
                if m["max_rel_err_kernels"] > MG_PARAM_RTOL or \
                        m["plain_share"] > 1.0 or \
                        max(abs(a_ - b_) / max(abs(b_), 1e-30)
                            for want in refs.values()
                            for a_, b_ in zip(m["losses"], want)) > \
                        MG_LOSS_RTOL:
                    fail(f"24b {shape} rank {r}: params "
                         f"{m['max_rel_err_kernels']:.3e} of their magnitude "
                         f"from one device through the kernels (rtol "
                         f"{MG_PARAM_RTOL}); through the plain versions "
                         f"{m['plain_share']:.3e} of their bound "
                         f"({MG_PARAM_RTOL} of a leaf's magnitude + "
                         f"{MG_PLAIN_UPDATE_RTOL} of its update); losses "
                         f"{m['losses']} vs "
                         f"{refs}")
            want_heads = [6] if "model" in shape else [12]
            for r, m in ((0, r0), (1, r1)):
                if m["heads"] != want_heads:
                    fail(f"24b {shape} rank {r}: flash heads {m['heads']}")
                expect_launches(m["launches"], {
                    "flash_attention_fwd": 12 * MG_SGD_STEPS,
                    "flash_attention_dq": 12 * MG_SGD_STEPS,
                    "flash_attention_dkv": 12 * MG_SGD_STEPS,
                    "bias_gelu": 12 * MG_SGD_STEPS,
                    "layernorm_act": MG_SGD_STEPS,
                    "fused_sgd": MG_SGD_STEPS}, f"24b {shape} rank {r}")
                sync = (f"gradient sync median "
                        f"{statistics.median(m['sync_ms']):.3f} ms"
                        if m["sync_ms"] else "no gradient sync (dp 1)")
                print(f"24b {shape} rank {r}: {MG_SGD_STEPS} SGD steps, params"
                      f" bit-identical across the ranks after every step, "
                      f"{m['max_rel_err_kernels']:.3e} of their magnitude "
                      f"from one device through the kernels (rtol "
                      f"{MG_PARAM_RTOL}), through the plain versions "
                      f"{m['plain_share']:.3e} of their bound "
                      f"({MG_PARAM_RTOL} of a leaf's magnitude + "
                      f"{MG_PLAIN_UPDATE_RTOL} of its update); losses "
                      f"{m['losses']} (one device {refs['kernels']}, plain "
                      f"{refs['plain']}); pieces "
                      f"{m['pieces']}; flash heads {m['heads']}; launches "
                      f"{ {k: v for k, v in m['launches'].items() if v} }; "
                      f"step ms {[round(s, 3) for s in m['step_ms']]}, "
                      f"{sync} ({card})")
                print(f"24b {shape} rank {r}: each kernel against its plain "
                      f"version on the inputs of its first launch "
                      f"{m['checked']} and the optimizers on the rank's "
                      f"own pieces, max abs err {m['errs']} (phase 2's "
                      f"tolerances; the optimizers bit-identical)")
        for r in ranks:
            print(f"24b rank {r['rank']} collectives: {r['collectives']} "
                  f"('device': gloo took the CUDA tensors on the card; "
                  f"'host': staged through host memory, gloo takes them on "
                  f"the CPU only)")
        print("24b waits for a machine with more than one card: every NCCL "
              "collective between two cards, ring attention's and the "
              "pipeline's point-to-point sends and MoE's all_to_all (NCCL "
              "refuses two ranks on one device); their CPU tests run them "
              "over gloo")
        errs = {}
        for r in ranks:
            for m in r["modes"].values():
                for k, v in m["errs"].items():
                    errs[k] = max(errs.get(k, 0.0), v)
        # the optimizers over 24a's and a data=2 rank's table, BERT-base's
        # whole leaves: held to their plain versions, then timed
        from analytics_zoo_torch.pipeline.api.keras.topology import (
            tree_leaves)
        leaves = [t.to(dev) for t in tree_leaves(
            mg_net(torch).get_variables()["params"])]
        for k, v in opt_leaves_check(torch, leaves, "24 BERT-base",
                                     sgd_momentum=0).items():
            errs[k] = max(errs[k], v)
        times = time_updates(torch, leaves, card, "24 BERT-base",
                             sgd_momentum=0)
        del leaves
        torch.cuda.empty_cache()
        print(f"phase 24: {time.perf_counter() - t_phase:.1f} s (the "
              f"controls {control_s:.1f} s, 24a's command {a_s:.1f} s, "
              f"24b's {b_s:.1f} s) ({card})")
        return {"a_launches": a["launches"],
                "b_launches": ranks[0]["modes"][json.dumps(
                    MG_SHAPES[0])]["launches"],
                "errs": errs, "times": times}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def multi_gpu_alone() -> None:
    """Phase 24 by itself (``--multi-gpu``)."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    multi_gpu_phase(torch, card, ctx.device)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.ops import fused, kernels
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.ops.activations import gelu
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    from analytics_zoo_torch.pipeline.inference import InferenceModel

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {len(kernels.SIGNATURES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    dev = ctx.device
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    report = {}

    # ----------------------------------- 2. kernels against plain versions
    # flash forward against the plain version, and two launches against
    # each other
    b, h, t, d = FLASH_SHAPES[0]
    for shape in FLASH_SHAPES:
        q, k, v = (randn(*shape) for _ in range(3))
        for causal in (False, True):
            tag = f"{shape} causal={causal}"
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err_o = close(f"flash forward {tag} O", o, o_ref, FWD_ATOL,
                          FWD_RTOL)
            err_l = close(f"flash forward {tag} LSE", lse, lse_ref,
                          FWD_LSE_ATOL)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"flash forward {tag}: two launches differ")
            print(f"check flash_attention_fwd {tag} f32: O max abs err "
                  f"{err_o:.3e} (|O| max {float(o_ref.abs().max()):.3e}, "
                  f"atol {FWD_ATOL}, rtol {FWD_RTOL}), LSE {err_l:.3e} (atol "
                  f"{FWD_LSE_ATOL}); two launches bit-identical")
            if shape == FLASH_SHAPES[0] and not causal:
                flash_err = max(err_o, err_l)
    del o2, lse2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (randn(b, h, t, d) for _ in range(3))
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    plain = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v))
    lib = time_ms(torch, lambda: sdpa(q, k, v))
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_eff = time_ms(torch, lambda: sdpa(q, k, v))
    print(f"library: f32 scaled_dot_product_attention forward {lib:.5f} ms "
          f"(PyTorch's choice of backend), {lib_eff:.5f} ms "
          f"(EFFICIENT_ATTENTION forced); the kernel {ms:.5f} ms ({card})")
    fwd_bytes, fwd_flops = (4 * b * h * t * d + b * h * t) * 4, \
        4 * b * h * t * t * d
    bnd, by = flash_bound_ms(fwd_bytes, fwd_flops)
    print(f"bound flash_attention_fwd {(b, h, t, d)}: {bnd:.6f} ms ({by}, "
          f"3xTF32); float32 FMA bound "
          f"{bound_ms(fwd_bytes, fwd_flops)[0]:.6f} ms")
    report["flash_attention_fwd"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/flash_attention_fwd.cu",
        replaces="analytics_zoo_tpu/ops/pallas_attention.py:51",
        max_abs_err=flash_err, ms=ms, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=lib)

    rows, dd = 8 * 512, 3072
    x, bias = randn(rows, dd), randn(dd)
    got, want = fused.bias_gelu_kernel(x, bias), fused.bias_gelu_ref(x, bias)
    torch.cuda.synchronize()
    err = close("bias_gelu", got, want, 1e-6)
    print(f"check bias_gelu {(rows, dd)} f32: max abs err {err:.3e}")
    ms = time_ms(torch, lambda: fused.bias_gelu_kernel(x, bias))
    plain = time_ms(torch, lambda: fused.bias_gelu_ref(x, bias))
    bnd, by = bound_ms((2 * rows * dd + dd) * 4, 0)
    report["bias_gelu"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/bias_gelu.cu",
        replaces="analytics_zoo_tpu/ops/fused.py:518", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)

    dl = 768
    gamma, beta = randn(dl) * 0.1 + 1.0, randn(dl) * 0.1
    for shape, act in (((4096, dl), None), ((8, dl), gelu)):
        x = randn(*shape)
        got = fused.layernorm_act_kernel(x, gamma, beta, 1e-5, act)
        want = fused.layernorm_act_ref(x, gamma, beta, 1e-5, act)
        torch.cuda.synchronize()
        err = close(f"layernorm_act {shape}", got, want, 1e-5)
        name = "gelu" if act else "none"
        ms = time_ms(torch, lambda: fused.layernorm_act_kernel(
            x, gamma, beta, 1e-5, act))
        plain = time_ms(torch, lambda: fused.layernorm_act_ref(
            x, gamma, beta, 1e-5, act))
        bnd, by = bound_ms((2 * shape[0] * dl + 2 * dl) * 4, 0)
        # with no activation one library call computes the same function
        lib = "none (no single call)" if act else "{:.5f}".format(
            time_ms(torch, lambda: torch.nn.functional.layer_norm(
                x, (dl,), gamma, beta, 1e-5)))
        print(f"check layernorm_act {shape} act={name} f32: max abs err "
              f"{err:.3e}; kernel_ms {ms:.5f} plain_ms {plain:.5f} "
              f"library_ms {lib} (torch.nn.functional.layer_norm) "
              f"bound_ms {bnd:.6f} ({card})")
    # the kernel's fixed cost: a launch and one round trip, at (1, 4)
    x1, g1, b1 = randn(1, 4), randn(4) * 0.1 + 1.0, randn(4) * 0.1
    err1 = close("layernorm_act (1, 4)",
                 fused.layernorm_act_kernel(x1, g1, b1, 1e-5, gelu),
                 fused.layernorm_act_ref(x1, g1, b1, 1e-5, gelu), 1e-5)
    fixed = time_ms(torch, lambda: fused.layernorm_act_kernel(
        x1, g1, b1, 1e-5, gelu))
    print(f"check layernorm_act (1, 4) act=gelu f32: max abs err "
          f"{err1:.3e}; kernel_ms {fixed:.5f}, the kernel's fixed cost "
          f"(a launch and one round trip) ({card})")
    # the serving path's shape is (8, 768) with gelu: the last one above
    report["layernorm_act"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/layernorm_act.cu",
        replaces="analytics_zoo_tpu/ops/fused.py:550", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    # flash backward: dQ and dK/dV, against the plain versions, and two
    # launches against each other
    for shape in FLASH_SHAPES:
        q, k, v, do = (randn(*shape) for _ in range(4))
        for causal in (False, True):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            delta = fa.flash_attention_delta(o, do)
            dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal)
            dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
            dq2 = fa.flash_attention_dq(q, k, v, do, lse, delta, causal)
            dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
            dq_ref = fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal)
            dk_ref, dv_ref = fa.flash_attention_dkv_ref(q, k, v, do, lse,
                                                        delta, causal)
            torch.cuda.synchronize()
            tag = f"{shape} causal={causal}"
            err_q = close(f"dQ {tag}", dq, dq_ref, BWD_ATOL, BWD_RTOL)
            err_k = close(f"dK {tag}", dk, dk_ref, BWD_ATOL, BWD_RTOL)
            err_v = close(f"dV {tag}", dv, dv_ref, BWD_ATOL, BWD_RTOL)
            if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and
                    torch.equal(dv, dv2)):
                fail(f"flash backward {tag}: two launches differ")
            print(f"check flash backward {tag} f32: dQ max abs err "
                  f"{err_q:.3e}, dK {err_k:.3e}, dV {err_v:.3e} (|dQ| max "
                  f"{float(dq_ref.abs().max()):.3e}, atol {BWD_ATOL}, rtol "
                  f"{BWD_RTOL}); two launches bit-identical")
            if shape == (b, h, t, d) and not causal:
                errs = (err_q, max(err_k, err_v))
    q, k, v, do = (randn(b, h, t, d) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_delta(o, do)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sdpa_out = sdpa(qg, kg, vg)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True))
    n_el = b * h * t * d
    for name, fn, plain_fn, reads, writes, flops, err in (
            ("flash_attention_dq",
             lambda: fa.flash_attention_dq(q, k, v, do, lse, delta),
             lambda: fa.flash_attention_dq_ref(q, k, v, do, lse, delta),
             4, 1, 6, errs[0]),
            ("flash_attention_dkv",
             lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta),
             lambda: fa.flash_attention_dkv_ref(q, k, v, do, lse, delta),
             4, 2, 8, errs[1])):
        ms = time_ms(torch, fn)
        plain = time_ms(torch, plain_fn)
        moved = ((reads + writes) * n_el + 2 * b * h * t) * 4
        bnd, by = flash_bound_ms(moved, flops * b * h * t * t * d)
        print(f"bound {name} {(b, h, t, d)}: {bnd:.6f} ms ({by}, 3xTF32); "
              f"float32 FMA bound "
              f"{bound_ms(moved, flops * b * h * t * t * d)[0]:.6f} ms")
        report[name] = dict(
            route="cuda", source="analytics_zoo_torch/csrc/flash_attention_bwd.cu",
            replaces=("analytics_zoo_tpu/ops/pallas_attention.py:94"
                      if name.endswith("dq") else
                      "analytics_zoo_tpu/ops/pallas_attention.py:134"),
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)
    pair = time_ms(torch, lambda: (
        fa.flash_attention_dq(q, k, v, do, lse, delta),
        fa.flash_attention_dkv(q, k, v, do, lse, delta)))
    print(f"library: f32 scaled_dot_product_attention backward (dQ, dK, dV "
          f"together) {lib:.5f} ms; the kernels' pair (dQ then dK/dV) "
          f"{pair:.5f} ms ({card})")
    del q, k, v, do, o, lse, delta, qg, kg, vg, sdpa_out

    # fused optimizer updates, in place: a kernel run and a plain run on
    # copies of the same leaf, then the comparison
    def leaves(n, seed):
        g2 = torch.Generator(device=dev).manual_seed(seed)
        p_, g_, m_ = (torch.randn(n, generator=g2, device=dev)
                      for _ in range(3))
        v_ = torch.rand(n, generator=g2, device=dev) * 0.01
        return p_, g_, m_, v_

    adam_kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    adam_scal = fused.step_scalars(None, -1e-4, 1 - 0.9 ** 3,
                                   1 - 0.999 ** 3, dev)
    sgd_kw = dict(momentum=0.9, nesterov=False)
    sgd_scal = fused.step_scalars(None, -1e-3, device=dev)
    for name, n_moments, update, scal, kw, lib_opt in (
            ("fused_adam", 2, fused.adam_leaf_update, adam_scal, adam_kw,
             lambda prm: torch.optim.Adam([prm], lr=1e-4, fused=True)),
            ("fused_sgd", 1, fused.sgd_leaf_update, sgd_scal, sgd_kw,
             lambda prm: torch.optim.SGD([prm], lr=1e-3, momentum=0.9,
                                         fused=True))):
        for n in (EMBED_LEAF, SMALL_LEAF):
            args = list(leaves(n, 7))[:2 + n_moments]
            ref = [a.clone() for a in args]
            update(*args, scal, **kw)
            plain_route(lambda: update(*ref, scal, **kw))
            torch.cuda.synchronize()
            err = max(close(f"{name} n={n}", a, r, OPT_ATOL)
                      for a, r in zip(args[:1] + args[2:],
                                      ref[:1] + ref[2:]))
            print(f"check {name} n={n} f32: max abs err {err:.3e} "
                  f"(tolerance {OPT_ATOL}: bit-identical)")
            if n == EMBED_LEAF:
                big_err, big = err, args
        ms = time_ms(torch, lambda: update(*big, scal, **kw))
        plain = time_ms(torch, lambda: plain_route(
            lambda: update(*big, scal, **kw)))
        prm = big[0].clone().requires_grad_()
        prm.grad = big[1].clone()
        opt = lib_opt(prm)
        lib = time_ms(torch, opt.step)
        del opt, prm
        moved = (7 if n_moments == 2 else 5) * EMBED_LEAF * 4
        bnd, by = bound_ms(moved, 0)
        report[name] = dict(
            route="cuda", source=f"analytics_zoo_torch/csrc/{name}.cu",
            replaces=("analytics_zoo_tpu/ops/fused.py:178"
                      if name == "fused_adam" else
                      "analytics_zoo_tpu/ops/fused.py:200"),
            max_abs_err=big_err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)
        del big, args, ref
    torch.cuda.empty_cache()

    for name, r in report.items():
        print(f"time {name}: kernel_ms {r['ms']:.5f} plain_ms "
              f"{r['plain_ms']:.5f} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}) ({card})")
    del o_ref, lse_ref, x, got, want

    # ------------------- 2b. int8 products against their plain routes
    int8_products(torch, card, dev)

    from analytics_zoo_torch.compile.engine import CAPTURE_LOG
    # -------------------------------------- 3. the slice at full width
    mark = len(CAPTURE_LOG)
    t0 = time.perf_counter()
    model = bert_base()
    model.model.init(torch.Generator().manual_seed(0))
    n_params = sum(int(p.numel()) for layer in
                   model.get_variables()["params"].values()
                   for p in layer.values())
    im = InferenceModel().load_zoo(model)
    print(f"model: {n_params} params, built and placed in "
          f"{time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    requests = [rs.randint(0, 30522, size=(8, 512)).astype(np.int64)
                for _ in range(4)]
    im.predict(requests[0], batch_size=8)          # warm-up, not counted

    kernels.reset_launch_counts()
    lat, outs = [], []
    for req in requests:
        s = time.perf_counter()
        outs.append(im.predict(req, batch_size=8))  # returns host numpy
        lat.append((time.perf_counter() - s) * 1e3)
    launches = kernels.launch_counts()
    for out in outs:
        if out.shape != (8, 20) or not np.isfinite(out).all():
            fail(f"serving output shape {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
    want = {name: 0 for name in kernels.SIGNATURES}
    want.update(flash_attention_fwd=48, bias_gelu=48, layernorm_act=4)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    print(f"serving launches over 4 requests: {launches}")

    get_config().set("ops.fused", "torch")
    plain_out = im.predict(requests[0], batch_size=8)
    get_config().set("ops.fused", "auto")
    if kernels.launch_counts() != want:
        fail("ops.fused=torch launched a kernel")
    diff = float(np.abs(plain_out - outs[0]).max())
    print(f"ops.fused=torch vs kernels, logits max abs diff {diff:.3e} "
          f"(tolerance {MODEL_ATOL}), logits max abs "
          f"{float(np.abs(outs[0]).max()):.3e}")
    if not diff <= MODEL_ATOL:
        fail(f"kernel and plain logits differ by {diff} > {MODEL_ATOL}")
    med = statistics.median(lat)
    print(f"serving: per-request latency median {med:.3f} ms over "
          f"{lat}, {8 * 1e3 / med:.1f} sequences/s, batch 8 x 512 tokens "
          f"({card})")
    serving_launches = launches
    front_end(torch, im, card, fail)
    # ------------------------- 3c. the same model served weight-only int8
    int8_launches = int8_serving(torch, card, model, im, requests, outs)
    del im
    report_captures("phases 3-3c", mark, card)
    mark = len(CAPTURE_LOG)

    # ---------------------------------------- 4. training at full width
    loss_name = "sparse_categorical_crossentropy_with_logits"
    n_leaves = len(tree_leaves(model.get_variables()["params"]))
    x_train = rs.randint(0, 30522, size=(64, 512)).astype(np.int64)
    y_train = rs.randint(0, 20, size=(64,)).astype(np.int64)
    model.compile(Adam(lr=1e-4), loss_name, metrics=["accuracy"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = model.fit(x_train, y_train, batch_size=8, nb_epoch=1, rng=0)
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    steps = 8
    want = {name: 0 for name in kernels.SIGNATURES}
    want.update({"flash_attention_fwd": 12 * steps,
                 "flash_attention_dq": 12 * steps,
                 "flash_attention_dkv": 12 * steps, "bias_gelu": 12 * steps,
                 "layernorm_act": steps, "fused_adam": steps})
    if launches != want:
        fail(f"training launch counts {launches} != {want}")
    loss = history[0]["loss"]
    if len(history) != 1 or not np.isfinite(loss):
        fail(f"fit history {history}")
    print(f"fit: 8 steps of batch 8 x 512 in {fit_s:.3f} s (first epoch, "
          f"warm-up included), epoch loss {loss:.5f}; launches {launches} "
          f"({n_leaves} float32 leaves)")
    training_launches = launches
    scores = model.evaluate(x_train, y_train, batch_size=8)
    if set(scores) != {"loss", "sparse_categorical_accuracy"} or \
            not all(np.isfinite(v) for v in scores.values()) or \
            not 0.0 <= scores["sparse_categorical_accuracy"] <= 1.0:
        fail(f"evaluate scores {scores}")
    print(f"evaluate: {scores}")
    # the main path's optimizer shape: the model's 154 leaves in one launch,
    # bit-identical leaf by leaf, then timed; these numbers go to the
    # kernels line
    bert_leaves = tree_leaves(model.get_variables()["params"])
    bert_errs = opt_leaves_check(torch, bert_leaves, "BERT-base")
    bert_times = time_updates(torch, bert_leaves, card, "BERT-base",
                              profile=True)
    for name, r in bert_times.items():
        report[name].update({key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    del bert_leaves

    loss_fn = objectives.get(loss_name)
    batch_np = (x_train[:8], y_train[:8])

    def timed_steps(mode, n):
        get_config().set("ops.fused", mode)
        tr = DistributedTrainer(model.model, loss_fn,
                                optim_method=Adam(lr=1e-4))
        params = tr.place_params(model.get_variables()["params"])
        opt_state, state = tr.init_opt_state(params), {}
        batch = tr.put_batch(batch_np)
        out = []
        for i in range(n + 1):                 # the first is a warm-up
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            params, opt_state, state, step_loss = tr.train_step(
                params, opt_state, state, batch, step_generator(0, i, dev))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - s0) * 1e3)
        if not np.isfinite(float(step_loss)):
            fail(f"step loss {float(step_loss)} under ops.fused={mode}")
        return out[1:]

    step_ms = {"torch": [], "auto": []}
    for mode in ("torch", "auto", "auto", "torch"):
        step_ms[mode] += timed_steps(mode, 4)
    get_config().set("ops.fused", "auto")
    for mode in ("auto", "torch"):
        med = statistics.median(step_ms[mode])
        print(f"training step ops.fused={mode}: median {med:.3f} ms over "
              f"{step_ms[mode]}, {8 * 1e3 / med:.1f} sequences/s, batch 8 x "
              f"512 tokens, Adam ({card})")

    report_captures("phase 4", mark, card)
    # ------------------------- 5. kernel route against plain route, grads
    from analytics_zoo_torch.ops import dtypes
    tr = DistributedTrainer(model.model, loss_fn, optim_method=Adam(lr=1e-4))
    params = tr.place_params(model.get_variables()["params"])
    batch = tr.put_batch(batch_np)
    for compute, tol in (("float32", GRAD_RTOL_F32),
                         ("bfloat16", GRAD_RTOL_BF16)):
        dtypes.set_policy(compute_dtype=compute)
        grads = {}
        for mode in ("auto", "torch"):
            get_config().set("ops.fused", mode)
            kernels.reset_launch_counts()
            loss_m, g, _ = tr.loss_and_grads(params, {}, batch,
                                             step_generator(11, 0, dev))
            grads[mode] = (float(loss_m), tree_leaves(g))
            counts = kernels.launch_counts()
            if mode == "torch" and any(counts.values()):
                fail(f"ops.fused=torch launched kernels {counts}")
            if mode == "auto" and counts["flash_attention_dkv"] != 12:
                fail(f"ops.fused=auto gradient launches {counts}")
        get_config().set("ops.fused", "auto")
        errs = [rel_l2(a, b_) for a, b_ in zip(grads["auto"][1],
                                               grads["torch"][1])]
        worst = max(errs)
        print(f"gradients, kernels vs plain versions, dtype.compute="
              f"{compute}: {len(errs)} leaves, relative L2 error max "
              f"{worst:.3e} median {statistics.median(errs):.3e} "
              f"(tolerance {tol}); loss {grads['auto'][0]:.6f} vs "
              f"{grads['torch'][0]:.6f}")
        if not worst <= tol:
            fail(f"kernel and plain gradients differ under dtype.compute="
                 f"{compute}: relative L2 {worst} > {tol}")
    dtypes.restore_policy(None)
    del tr, params, grads

    # ------------------------------------------------- 6. SGD through fit
    model.compile(SGD(1e-3, momentum=0.9), loss_name)
    kernels.reset_launch_counts()
    sgd_history = model.fit(x_train[:16], y_train[:16], batch_size=8,
                            nb_epoch=1, rng=1)
    sgd_launches = kernels.launch_counts()
    if sgd_launches["fused_sgd"] != 2 or \
            sgd_launches["fused_adam"] != 0 or \
            not np.isfinite(sgd_history[0]["loss"]):
        fail(f"SGD fit: launches {sgd_launches}, history {sgd_history}")
    print(f"SGD(momentum=0.9) fit: 2 steps, loss "
          f"{sgd_history[0]['loss']:.5f}, launches {sgd_launches}")

    # ------------------------------------ 7. NeuralCF at bench_ncf's shape
    mark = len(CAPTURE_LOG)
    ncf_launches, ncf_errs, ncf_times = ncf_phase(torch, card)
    report_captures("phases 6-7b", mark, card)
    # ---------------------------------- 8. Wide & Deep, census configuration
    mark = len(CAPTURE_LOG)
    wd_launches, wd_errs, wd_times = wide_deep_phase(torch, card)
    report_captures("phase 8", mark, card)
    # --------------------- 9. the cnn TextClassifier, calibrated int8
    mark = len(CAPTURE_LOG)
    cnn_int8(torch, card)
    report_captures("phase 9", mark, card)
    # ------------- 10. the lstm/gru TextClassifier at the reference width
    mark = len(CAPTURE_LOG)
    rec_profile = recurrent_phase(torch, card)
    report_captures("phase 10", mark, card)
    # ---------------- 11. Seq2seq and generative serving, bench config
    mark = len(CAPTURE_LOG)
    generative_phase(torch, card)
    report_captures("phase 11", mark, card)
    # ----------------------- 12. SessionRecommender over ML-1M's items
    mark = len(CAPTURE_LOG)
    session_phase(torch, card)
    report_captures("phase 12", mark, card)
    # ------------------- 13. image classification: ResNet-50 at the bench
    mark = len(CAPTURE_LOG)
    img_launches, img_errs, img_times = image_phase(torch, card, dev)
    report_captures("phase 13", mark, card)
    for name in ("fused_adam", "fused_sgd"):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          bert_errs[name], ncf_errs[name],
                                          wd_errs[name], img_errs[name])
    for what, times in (("BERT-base", bert_times), ("NeuralCF", ncf_times),
                        ("Wide & Deep", wd_times), ("ResNet-50", img_times)):
        for name, r in times.items():
            print(f"time {name} over {what}'s {r['leaves']} leaves: kernel_ms "
                  f"{r['ms']:.5f} update_ms {r['update_ms']:.5f} plain_ms "
                  f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
                  f"bound_ms {r['bound_ms']:.6f} host_ms {r['host_ms']:.5f} "
                  f"({card})")

    # --------------------- 14. the flash kernels on bf16, bench_attention
    report.update(flash_bf16_phase(torch, card, dev))

    # -------------- 15. model persistence: resume, retry, load, serve
    mark = len(CAPTURE_LOG)
    persist_launches = persistence_phase(torch, card, dev, rec_profile)
    report_captures("phase 15", mark, card)

    # ------- 16. the Keras transformer models: GPT-1 served and trained,
    # BERT-base fine-tuned, a checkpoint loaded, the route at seq_len 77
    mark = len(CAPTURE_LOG)
    (gpt_serve, gpt_train, bert_tune), _ = transformer_phase(torch, card,
                                                             dev)
    report_captures("phase 16", mark, card)

    # -------- 17. the rest of the Keras surface: AnomalyDetector trained
    # and served, the 64-class layer sweep, the regularizers
    kernels.reset_launch_counts()
    mark = len(CAPTURE_LOG)
    ad_launches = keras_surface_phase(torch, card, dev)
    report_captures("phase 17", mark, card)
    print(f"launches: AnomalyDetector fit ({AD_EPOCHS} epochs) "
          f"{ad_launches}")

    # ------ 18. KNRM trained and ranked, MoE, ConvLSTM, the training
    # switches at BERT-base width, keras2 and autograd
    mark = len(CAPTURE_LOG)
    knrm_launches, moe_launches = text_matching_phase(torch, card, dev)
    report_captures("phase 18", mark, card)
    print(f"launches: KNRM fit ({KNRM_EPOCHS} epochs) {knrm_launches}; MoE "
          f"({MOE_STEPS} steps) {moe_launches}")

    # -------------------------- 19. compile and warm start (--compile)
    compile_phase(torch, card, dev)

    # ------- 20. the data pipeline and offline batch scoring (--data-pipeline)
    data_pipeline_phase(torch, card, dev)

    # ------- 21. images in: image records, SSD-300 served and trained,
    # NNFrames on Wide & Deep (--images)
    ssd_launches, img21_errs, ssd_times, nn_times = images_phase(
        torch, card, dev)
    for name in ("fused_adam", "fused_sgd"):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          img21_errs[name])
    for what, times in (("SSD-300", ssd_times),
                        ("Wide & Deep under NNClassifier", nn_times)):
        for name, r in times.items():
            print(f"time {name} over {what}'s {r['leaves']} leaves: kernel_ms "
                  f"{r['ms']:.5f} update_ms {r['update_ms']:.5f} plain_ms "
                  f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
                  f"bound_ms {r['bound_ms']:.6f} host_ms {r['host_ms']:.5f} "
                  f"({card})")

    # ---- 22. models from other frameworks: Inception-v1 through TFPark,
    # ResNet-50 from ONNX, TorchNet, the W&D bench, the GAN (--interop)
    (inc_launches, onnx_launches, interop_errs, inc_times,
     onnx_times) = interop_phase(torch, card, dev)
    for name in ("fused_adam", "fused_sgd"):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          interop_errs[name])
    for what, times in (("Inception-v1", inc_times),
                        ("ResNet-50 (ONNX)", onnx_times)):
        for name, r in times.items():
            print(f"time {name} over {what}'s {r['leaves']} leaves: kernel_ms "
                  f"{r['ms']:.5f} update_ms {r['update_ms']:.5f} plain_ms "
                  f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
                  f"bound_ms {r['bound_ms']:.6f} host_ms {r['host_ms']:.5f} "
                  f"({card})")

    # ---- 23. the local trainer and the serving fleet: LocalEstimator on
    # BERT-base, the watchdog drill, the autoscaled fleet of BERT-base
    # replicas stormed, the tools over its run dir, quick_start (--fleet)
    fleet_launches, _, fleet_adam_err, fleet_adam_times = fleet_phase(
        torch, card, dev)
    report["fused_adam"]["max_abs_err"] = max(
        report["fused_adam"]["max_abs_err"], fleet_adam_err)
    r = fleet_adam_times
    print(f"time fused_adam over AnomalyDetector's {r['leaves']} leaves: "
          f"kernel_ms {r['ms']:.5f} update_ms {r['update_ms']:.5f} plain_ms "
          f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} bound_ms "
          f"{r['bound_ms']:.6f} host_ms {r['host_ms']:.5f} ({card})")

    # ---- 24. multi-GPU: Estimator.train on an NCCL world of one through
    # launch_cli, then two gloo ranks on the card under data, fsdp and
    # model parallelism (--multi-gpu)
    kernels.reset_launch_counts()
    mg = multi_gpu_phase(torch, card, dev)
    for name, r in mg["times"].items():
        print(f"time {name} over BERT-base's {r['leaves']} leaves (momentum "
              f"0 for SGD): kernel_ms {r['ms']:.5f} update_ms "
              f"{r['update_ms']:.5f} plain_ms {r['plain_ms']:.5f} library_ms "
              f"{r['library_ms']:.5f} bound_ms {r['bound_ms']:.6f} host_ms "
              f"{r['host_ms']:.5f} ({card})")

    # ------------------------------------------------------ 25. results
    print(f"launches: GPT-1 serving (4 requests) {gpt_serve}; GPT-1 fit "
          f"(8 steps) {gpt_train}; BERT-base fine-tuning (8 steps) "
          f"{bert_tune}")
    print(f"launches: serving (4 requests) {serving_launches}; int8 "
          f"weight-only serving (4 requests) {int8_launches}; training "
          f"(fit, 8 steps) {training_launches}; SGD fit (2 steps) "
          f"{sgd_launches}; NeuralCF fit {ncf_launches}; Wide & Deep fit "
          f"{wd_launches}; ResNet-50 train_step (a turn of "
          f"{RESNET_UNTIMED + RESNET_TIMED} steps) {img_launches}; "
          f"resumed BERT-base fit (phase 15a, 16 + 8 steps) "
          f"{persist_launches}")
    print(f"launches: SSD-300 train_step (phase 21c, "
          f"{SSD_TRAIN_WARM + SSD_TRAIN_TIMED} steps) {ssd_launches}")
    print(f"launches: Inception-v1 KerasModel.fit (phase 22a) "
          f"{inc_launches}; ResNet-50 (ONNX) train_step (phase 22b, "
          f"{ONNX_TRAIN_STEPS} steps) {onnx_launches}")
    print(f"launches: phase 23 {fleet_launches}")
    # this slice's main path is phase 24: the float32 forward and backward
    # kernels' and Adam's launches are 24a's Estimator steps on the NCCL
    # world of one (launch_cli's child), SGD's 24b rank 0's data-parallel
    # steps; the optimizers' times are those over BERT-base's leaves (SGD
    # at momentum 0, as 24b), their errors those on phase 24's tables
    # (the earlier models' are printed above); every other kernel's error
    # is the largest of phase 2's and 24b's
    report["fused_sgd"]["launches"] = mg["b_launches"]["fused_sgd"]
    for name in ("fused_adam", "fused_sgd"):
        report[name].update({key: mg["times"][name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        report[name]["max_abs_err"] = mg["errs"][name]
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "bias_gelu", "layernorm_act"):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          mg["errs"][name])
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "bias_gelu", "layernorm_act",
                 "fused_adam"):
        report[name]["launches"] = mg["a_launches"][name]
    for name, r in report.items():
        # phase 15a's resumed transformer training runs every float32
        # kernel but the optimizers'; phase 14's bench_attention run set
        # the bf16 kernels' launches
        if "launches" not in r:
            r["launches"] = persist_launches[name]
    line = {"kernels": [{"name": n, **{key: r[key] for key in (
        "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for n, r in report.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def keras_surface_alone() -> None:
    """Phase 17 by itself (``--keras-surface``): the kernels built, then
    AnomalyDetector, the layer sweep and the regularizers on the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    keras_surface_phase(torch, card, ctx.device)


def compile_alone() -> None:
    """Phase 19 by itself (``--compile``): the kernels built, then the
    captured routes against the eager ones and the warm start."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    compile_phase(torch, card, ctx.device)


def text_matching_alone() -> None:
    """Phase 18 by itself (``--text-matching``): the kernels built, then
    KNRM, MoE, ConvLSTM, the training switches, keras2 and autograd on
    the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    kernels.build_all()
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    text_matching_phase(torch, card, ctx.device)


if __name__ == "__main__":
    if sys.argv[1:] == ["--keras-surface"]:
        keras_surface_alone()
    elif sys.argv[1:] == ["--text-matching"]:
        text_matching_alone()
    elif sys.argv[1:] == ["--compile"]:
        compile_alone()
    elif sys.argv[1:] == ["--data-pipeline"]:
        data_pipeline_alone()
    elif sys.argv[1:] == ["--images"]:
        images_alone()
    elif sys.argv[1:] == ["--interop"]:
        interop_alone()
    elif sys.argv[1:] == ["--fleet"]:
        fleet_alone()
    elif sys.argv[1:] == ["--multi-gpu"]:
        multi_gpu_alone()
    elif sys.argv[1:2] == [MG_CHILD] and len(sys.argv) == 4:
        multi_gpu_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == [WARM_CHILD] and len(sys.argv) == 4:
        warm_start_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:] == ["--profile-recurrent"]:
        profile_recurrent()
    elif sys.argv[1:] == ["--profile-resnet"]:
        profile_resnet()
    elif sys.argv[1:] == ["--profile-seq2seq-train"]:
        profile_seq2seq_train()
    else:
        main()
