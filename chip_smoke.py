#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes
on):
 1. device: require CUDA; print the card's name and power limit
 2. build: compile every kernel from csrc/ (one nvcc per source, in
    parallel) into _build/dynamo_tpu_torch/<hash>/
 3. K2 paged_kv_write vs plain at Llama-3-8B geometry: bit-exact outside
    scratch page 0, on contiguous rows and on strided views (a slice of a
    wider projection output, a head-major tensor transposed)
 4. K3 paged_kv_write_pages vs plain at Llama-3-8B geometry (KVH 8, P 16,
    D 128, bf16): bit-exact outside page 0, several padding slots aimed at
    page 0, on contiguous blocks and on the chunk's token-major K/V viewed
    per page (what the chunk writer passes)
 5. K1 ragged_paged_attention vs plain at Llama-3-8B geometry, bf16 and
    fp32, on a ragged mix (decode rows to 4096 tokens of context, chunk
    rows straddling pages, padding rows that must be exact zeros) and on
    decode rows alone (split across CTAs); in bf16 also with q = 0, where
    the output is each row's exact mean of the V rows it can see; one bf16
    call captured in a CUDA graph and replayed with token_qpos changed in
    place on the device, equal to an eager call
 6. K4 paged_attention_decode vs plain at Llama-3-8B geometry, bf16 and
    fp32: length-0 lanes (exact zeros), lengths at page edges (1, 15, 16,
    17, 32), contexts to 4096 (split across CTAs); in bf16 also q = 0; one
    bf16 call captured in a CUDA graph and replayed with lengths changed in
    place, equal to an eager call
 3-6 at the draft's geometry (Llama-3.2-1B: H 32, KVH 8, D 64, P 16),
    bf16: K2 and K3 bit-exact outside page 0 on every source layout; K1
    (ragged mix, decode rows) and K4 (page edges, long lanes) within
    K1_BF16_TOL / K4_BF16_TOL, padding rows and empty lanes exact zeros,
    q = 0 at the uniform tolerance; and one K1 call at a verify round
    (8 lanes x 5 rows from unaligned cursors, D 128) against the plain
    version
 7. K5 w8a8_matmul and K6 int4_matmul vs plain at the four Llama-3-8B
    projection shapes (4096x4096 wq/wo, 4096x1024 wk/wv, 4096x14336
    gate/up, 14336x4096 down), M in A8_MS (both sides of every design
    edge: the stream GEMM's 8- and 16-row activation tiles, the wide GEMM
    above, with K6's 256- and 128-column tiles), bf16 and fp32
    activations, with an all-zero row (sx
    at its 1e-12 floor) and an outlier: outputs bit-identical; the
    grouped calls q/k/v and gate/up (one quantize, one GEMM) bit-identical
    with the plain version of each weight; one K5, one K6 and one grouped
    call captured in a CUDA graph, x changed in place, replayed: equal to
    an eager call
 7b. prefill attention through K1 (`attention.prefill_attention` on CUDA
    tensors) vs the plain prefill attention at the phase batch's widest
    chunk round (bp 8, T 512, contexts to 1041, cursors aligned and not,
    one padding lane): valid rows within K1_BF16_TOL, padding rows exact
    zeros, q = 0 through the same row tags at K1_UNIFORM_TOL; the KV
    gather (66 pages of 32 layers' K and V, one launch) bit-exact with the
    per-layer index_select stack
 8. main paths: Llama-3-8B at full width and depth (random weights from a
    seed) served through `dynamo_tpu_torch.run`'s pipeline, a batch of 10
    greedy chat requests of 16..1500 bytes with top-8 logprobs,
    prefill_chunk_budget 512; first the
    phase path (the default: k = 8 bursts, pipelined), then the ragged
    path (DYN_ATTENTION_IMPL=ragged) on the same weights; each with the
    launch counts zeroed just before and read just after, replayed CUDA
    graphs' launches included (phase: K1, K2, K3, K4 > 0 and K5 = K6 = 0;
    ragged: K1, K2 > 0 and K3 = K4 = K5 = K6 = 0); the path's graphed
    entries captured and replayed in the batch (phase "prefill",
    "mixed_step", "sample_first", "decode_burst"; ragged "ragged_step";
    captures and their seconds by entry from the compile tracker — they
    land in the first requests' TTFT — replays and the graphs' pool bytes
    printed); on the phase path a second, steady batch of fresh prompts of
    the same sizes (tok/s, TTFT p50, new captures beside the first
    batch's); greedy determinism; the same greedy request (100-token
    prompt, 12 tokens, top-8 logprobs) on both paths, equal up to a
    parting at a bf16 near-tie (BF16_TIE_TOL), printed with its step,
    tokens and gap
 8b. constrained sampling: the Llama-3-8B model (bf16, seed 0, byte
    tokenizer) on the phase engine and on the ragged engine, one batch of
    8 requests, max_tokens 32, all in flight — a choice, a regex and a
    JSON-mode lane, a presence-penalised [a-z]+ lane, a repetition
    penalty, min_p 0.1 at temperature 0.8 with a seed, two free lanes —
    with the launch counts zeroed just before and read just after (K2, K4
    and the path's prefill kernel, K3 or K1, > 0); the grammars compiled
    through the engine's host pool first (their seconds printed, JSON
    mode's among them); every guided output inside its grammar (a full
    match where it stopped), the presence lane with no letter twice;
    exactly one "decode_guided" capture per engine, at the packed tables'
    row bucket (capture seconds, replays and the resident table bytes
    printed); the same seeded request twice, identical. Then the bare
    8-lane "decode_guided" burst at 8B captured and replayed twice:
    bit-identical with the eager burst, its static inputs unchanged; its
    host wall, device busy and idle share, graphed, beside the plain
    "decode_burst" on the same lanes; the ops after the last layer
    (penalties, grammar mask, sampling) in device ms per step from an
    eager profile
 8c. the port as a deployment: `python -m dynamo_tpu_torch.coordinator`,
    `.worker` (the phase-8 checkpoint, random init, seed 0, cuda, round-
    robin, 2048 pages, batch 8, prefill chunk 512) and `.frontend` as
    subprocesses; phase 8's 10 requests through HTTP, all in flight,
    streamed: each a 200 with well-formed SSE ending in [DONE] and a
    finish_reason, its tokens those of the in-process phase-path batch or
    parting at a bf16 near-tie (BF16_TIE_TOL, printed with step and gap);
    TTFT p50/p99, ITL p50 and tok/s through HTTP beside the in-process
    batch's, the frontend's response frames per second, the worker's CUDA
    graph captures and replays (from its `_sys.stats` scrape); then the
    running worker answers one /v1/embeddings request (a 300-token input
    as ids; its vector within cosine 0.9999 of the in-process
    `embed_batch` on phase 8's weights), one n = 2 chat (two choices)
    and one /v1/responses request (completed, a message, its usage);
    every subprocess stopped at the end. The worker runs with
    `--system-port --health-check --health-check-interval 1` and
    DYN_WATCHDOG_STALL_S (WATCHDOG_STALL_S), the frontend with
    `--system-port --stream-idle-adaptive-margin` (ADAPTIVE_IDLE_MARGIN).
    The observability layer is armed on both: DYN_TRACE with a trace file
    each, DYN_AUDIT (JSONL sink), `--telemetry-interval 1`; the frontend
    also `--slo-ttft 0.001 --slo-itl 60 --slo-check-interval 1` (an
    objective no request meets and one none misses); the worker logs
    JSONL. Right after the 10 streams: each is one trace (the frontend's
    `http chat_completions` span, the worker's serve span, `engine.request`
    under it and its queue_wait, >= 1 prefill.chunk, prefill and decode
    stages; every parent resolved), /debug/requests lists the 10 with
    status 200 and those trace ids, per-request and median queue wait,
    prefill and decode ms printed beside the HTTP TTFT with the TTFT share
    inside chunk dispatches that captured a graph; /fleet/status holds
    the worker's and the frontend's snapshots, the worker's TTFT p50
    within one bucket of its scrape, SLO states ttft breach and itl ok,
    `dynamo_slo_burn_rate` on the frontend's /metrics and
    `dynamo_trace_dropped_total` 0 on both; the audit file has one record
    per stream with its text and usage. After the deployment stops,
    every worker stderr line parses as JSON. Before traffic: the worker's /live 200, its first idle canary through
    the cold engine (its wall printed: one token, its TTFT), /health 200
    healthy. After the extras: a guided wave (ITL_WAVE streams of 128
    letters) so the frontend holds >= 100 HTTP ITL samples, then idle
    for 3.5 canary intervals: canaries beyond the requests sent >= 2,
    /health still 200, /metrics on the system port with the same CUDA
    graph series as the `_sys.stats` scrape, /config naming torch and
    redacting DYN_SMOKE_API_TOKEN, 0 watchdog trips (the longest stall
    with work pending printed beside the threshold), 0 idle timeouts at
    the frontend and its derived adaptive idle timeout printed. Then, in
    process on phase 8's weights, the parser run (`parser_phase`): a
    phase-path engine behind `serve_engine` and `start_frontend` on a
    memory store under a card with tool_call_parser hermes and
    reasoning_parser basic (beside a card without parsers and one that
    sets the think regex on every request); launch counts zeroed just
    before its requests and read just after (K1-K4 > 0); a streamed and
    a unary tool chat under the hermes regex (one get_weather call with
    the forced arguments, finish "tool_calls", streamed = unary), a think
    chat (reasoning_content and content are the raw run's think text and
    what follows it), the think chat with n = 2 (each choice split) and
    /v1/responses (output_text without the think text); each wall
    printed
 8d. the KV router on the card: the coordinator, TWO `.worker`s with
    phase 8c's flags but `--router-mode kv` (Llama-3-8B full shape, random
    init seed 0, cuda, 2048 pages of 16 — fewer, printed, only if the
    card runs short —, batch 8, prefill chunk 512) and `.frontend
    --router-mode kv`; first each wave-2 request served alone and cold by
    an in-process phase-path engine on phase 8's weights (the reference
    streams). Wave 1: two distinct 1024-byte prefixes, one request each,
    max_tokens 8, sent at once: they land on different workers, and the
    frontend's `dynamo_router_index_blocks` reaches 64 for each worker.
    Wave 2: eight requests, four per prefix, each with its own 32-200 byte
    suffix, max_tokens 32, one after another: each lands on its prefix's
    worker (4 more requests on each, from the workers' `_sys.stats`
    scrapes, and `dynamo_router_prefill_tokens_saved_total` >= 8 x 64 x
    16), and its stream equals the cold one up to a bf16 near-tie
    (BF16_TIE_TOL, printed with step and gap). Wave 3: the eight again,
    all in flight (TTFT, ITL, tok/s and decisions per worker printed).
    Both workers replayed their "decode_burst" graphs; wave 1's TTFT
    beside wave 2's, the router's events by stream and its KV-event gaps
    (which must be 0) printed; the frontend runs with DYN_TRACE and
    DYN_ROUTER_LOG: each of the 18 requests has one `router.decide` span
    under its http span naming the worker the decision log records for
    it. The frontend also runs with DYN_KV_RECORD (its KV-event capture),
    DYN_PREFIX_HEAT=1 and `--telemetry-interval 1`; the prefix plane moves
    no placement, so the checks above stand. Its index is the native C++
    radix tree (its log line printed beside phase 2's build seconds).
    After wave 3 the capture is replayed into a fresh native and a fresh
    Python `KvIndexer`: at each of the 18 recorded decisions both score
    every candidate as the live router did, and after the last event both
    hold the live index's blocks per worker (`/debug/router`, as the
    scrape's `dynamo_router_index_blocks`); `/debug/prefixes` answers 200
    with 18 decisions (shadow divergences and tier-blind counts printed)
    and duplicate blocks equal to the replayed index's, (k-1) blocks of 2
    MiB (32 layers x 2 x 8 KV heads x 128 x 16 tokens x 2 bytes) for
    every block on k workers, by depth bucket; `/fleet/status` carries the
    prefix block; a MockEngine of block size 16 given wave 1's prompts as
    token ids stores exactly the seq-hash chain (hashes and parents) the
    real workers' captured `stored` events carry for their full blocks.
    Every subprocess stopped at the end
 8e. disaggregated serving, after 8d has stopped its workers: the
    coordinator, a `.worker --is-prefill-worker` (served as
    llama3-8b-prefill), a `.worker --enable-disagg
    --max-local-prefill-length 256` and `.frontend --router-mode kv`, all
    on the phase-8 checkpoint (random init, seed 0); phase 8's 10 requests
    all in flight, first with the CUDA IPC plane, then with the decode
    worker restarted under DYN_KV_PLANE=0 (the host wire; every other
    request, 3 remote and 2 local, to bound the script's time), then
    restarted with `--prefill-queue` (the plane on; the prefill worker runs
    `--prefill-queue` from the start and serves push too). Per request its
    path (remote above 256 prompt tokens), pull and import times, bytes
    and GB/s by pull path; remote TTFT p50 beside local; free memory before
    the workers start and with both up. Checks: with the plane on every
    remote pull rides the plane with 0 fallbacks, with it off the wire;
    in the queue set every remote prefill rides the queue (the prefill
    worker's `dynamo_prefill_queue_jobs{outcome="done"}` moves by the
    remote count, none failed; the largest queue depth seen printed);
    0 KV-event gaps and no dropped events at the frontend's router; every
    stream token-identical with phase 8's in-process batch or parting at
    a near-tie (BF16_TIE_TOL, printed as 8c prints them); the prefill
    worker launched the KV gather (its `_sys.stats` scrape)
 8j. the mock fleet and the wire faults, after 8e, no 8B worker running:
    the coordinator, four `.worker --mock --mock-total-blocks 1024
    --migration-limit 2` (instance ids 11-14) and `.frontend --router-mode
    kv` under DYN_KV_RECORD, DYN_PREFIX_HEAT=1 and DYN_ROUTER_LOG=1. No
    mock pid is among the card's compute processes and the card's used
    memory does not grow when they start (nvidia-smi). Wave 1: 16
    distinct prefixes of 256 words (16 full blocks behind the chat
    template), one request each; wave 2: 64 requests, 4 per prefix with
    its own suffix, max_tokens 16, one after another: each on its
    prefix's worker (the decision log) and
    `dynamo_router_prefill_tokens_saved_total` >= 64 x 15 x 16; wave 3:
    the 64 again, all in flight, all 200 (TTFT p50 and the router's
    decisions per second printed: host figures of the card's machine).
    0 KV-event gaps; the capture replays as in 8d (144 decisions);
    /debug/prefixes as in 8d at 1 MiB a block. At fleet size, in process:
    32 workers x 4096 blocks from a seeded event stream; the native and
    the Python tree agree on 1000 queries (microseconds per call
    printed). The fault pass: the frontend restarted with `--faults
    "kind=connect_refused,times=1;kind=disconnect,after=5,times=1"` and
    DYN_CONNECT_RETRIES=0: the first dial is refused and the router
    retries another instance; the stream is cut after 5 tokens and
    migrates, its tokens those of the undisturbed runs (the first 5, then
    the replay of the prompt and those 5: the mock's tokens are
    deterministic); 8 more requests all 200. In process, a runtime whose
    transport refuses one dial to worker 11 routes around it, and
    `ServiceClient.collect_services` shows its breaker's failure for that
    instance
 8f. KVBM, in process, on phase 8's weights: a phase-path engine (batch
    8, chunk budget 512, 320 pages + scratch, 0.63 GiB of KV) with a
    KvbmManager (host tier 1024 blocks of 2 MiB); 12 greedy requests, each
    a distinct 1024-byte prefix + its own 32-byte suffix (byte tokens, 66
    pages: the 792 pages are 2.5x the pool), max_tokens 8, top-8
    logprobs, after one warm-up request. Sync pass (every knob 0): the 12
    one at a time (cold), then again (revisit: onboards from G2); TTFT
    p50 of each, blocks offloaded / onboarded, the admission stall, the
    mean onboard split into host stack, host-to-device copy and K3 and
    the mean offload read split into gather, device-to-host copy and host
    split (the engine's `kvbm_stage` histograms: CUDA events), the gather
    and K3 launch counts (zeroed before the cold wave, read after the
    revisit; both > 0). Pipelined pass (queue 256, 2 IO workers, prefetch
    64; a fresh engine whose graphs capture while offloads run): the 12 in
    flight, twice; offload pins seen, inline offloads, prefetch hits,
    TTFT p50 per wave; blocks offloaded, onboarded and prefetch-hit all
    above 0, no inline offload, no pin left at the end. G3 pass (host 128
    blocks, disk 1024 in a temporary directory): a revisit wave one at a
    time, TTFT of the onboards from disk, each revisit held on disk
    onboarding blocks. G4 pass:
    two engines sharing the weights, each with a KvbmDistributed on one
    in-process runtime; A serves the 12 and 5 fillers (its pages go to its
    host tier) and clears its device cache; B serves the 12: blocks
    remote-onboarded, pull seconds and GB/s (fetch timeout 2 s, partial
    runs kept), B's TTFT beside its cold TTFT; A's tiers hold all 12
    prefixes and B remote-onboards blocks. Checks: every request
    finishes with 8 tokens and no refusal or error (a failed gather, K3
    launch or pinned allocation fails its request); every revisit / wave / G3 / G4
    stream equals its cold stream or parts at a near-tie (BF16_TIE_TOL,
    printed); KV event ids with no gap in every engine. Each pass runs
    under a process tracer of its own: the `kvbm.onboard` spans' blocks
    (and the request roots' `kvbm.onboard` events) add up to the pass's
    onboarded blocks, the pipelined pass's `kvbm.offload` spans to its
    offloaded blocks (the sync path's inline offloads run under no span,
    as the reference's), G4's remote onboard spans to B's remote-onboarded
    blocks
 8g. speculative decoding, in process, on phase 8's 8B weights and a
    random Llama-3.2-1B-shaped draft (DRAFT_1B_CONFIG, bf16, seed 1; its
    config read through the loader at the target's page geometry), on
    the phase path: gamma 4, 8 iterations a burst, batch 8, chunk budget
    512; phase 8's 10 requests all in flight (greedy, top-8 logprobs,
    max_tokens 32) with the launch counts zeroed just before and read
    just after (K1, K2, K3, K4 > 0, K5 = K6 = 0); "prefill",
    "prefill_draft", "sample_first" and "spec_decode" captured and the
    graphs replayed; every stream equal to phase 8's no-draft batch or
    parting at a near-tie (BF16_TIE_TOL, printed with step and gap);
    draft tokens > 0; greedy determinism; a seeded request at
    temperature 0.8 identical when run twice on an empty prefix cache,
    then once more with a prefix hit, and the same three runs on a
    no-draft phase engine (printed: whether the prefix hit moves the
    stream, and how far the first token's top-8 logprobs move). Then
    the disagreement rate of the draft's and the verify's argmax at the
    same positions (`draft_verify_disagreement`: the 8B model's greedy
    decode steps through K4 against its gamma + 1-row verify forwards
    through K1 over the same tokens), and a self-draft pass (the 8B
    model is its own draft, with caches of its own) on the first four
    requests at max_tokens 64 (at least two spec bursts): acceptance at
    or above the floor `self_draft_floor` derives from that rate, its
    streams equal to phase 8's over their 32 tokens or parting at
    near-ties. Printed per pass: the acceptance rate and tokens per
    burst (random weights: a bound on the path's cost, not a claim),
    tok/s and TTFT p50 (the 1B pass's steady batch beside phase 8's)
 8h. MoE and image chat: phase 8's 8B weights leave the card (phases
    9-13 draw them again from seed 0, as phase 8's engine drew them), then
    Mixtral-8x7B's published shape (MIXTRAL_CONFIG: 32 layers, hidden
    4096, FFN 14336, 8 experts top-2, vocab 32000) in int8, random
    weights from seed 0 drawn and quantized one expert at a time, page 16,
    a MOE_PAGES-page KV pool; the memory before and after the load and the
    weight bytes printed. The VQ image encoder's weights (trained at first
    use on the CPU), its tokens on the card equal to its plain numpy
    version on a 32x32 PNG written with the standard library. `moe_mlp`
    held against `moe_mlp_reference` at one layer, int8 stacks (the served
    layer) and bf16 stacks (one drawn layer), within MOE_BF16_TOL of the
    largest output (tokens at a router near-tie, ROUTER_TIE_TOL, counted
    apart). In process, on the phase path and then the ragged path over
    the same weights: 6 greedy text chats (max_tokens 16, top-8 logprobs)
    all in flight, then the same image chat twice (196 image tokens at
    offset 30000; the second a prefix hit), then an image chat at the
    default offset 128256 (its ids past the vocabulary read the clamped
    embedding row: its stream equals that of its prompt clamped into the
    vocabulary, up to a near-tie), each through the OpenAI pipeline and an
    in-process encode router; launch counts zeroed just before and read
    just after (phase: K1-K4 > 0; ragged: K1, K2 > 0; K5 = K6 = 0);
    every dispatch a CUDA-graph run, 0 eager (captures, capture seconds,
    replays, pool bytes printed); tok/s and TTFT p50 of the text batch;
    the two paths' streams equal or parting at near-ties (MOE_TIE_TOL).
    The bare 8-lane 8-step decode burst (`moe_burst_profile`): replayed
    from its graph bit-identical with eager, its host wall and device
    busy; the eager burst's device time split into the MoE FFN (expert
    GEMMs, the int8 -> bf16 conversion of the stacks, their scales,
    routing / gating / combine) beside attention (K2 + K4) and the rest.
    Then the deployment: the coordinator, `.worker` on a config-only
    Mixtral dir (int8, random init seed 0, `--encode-component
    encoder`), `.worker --encode-worker --image-vocab-offset 30000`, a
    second encode worker at the default offset behind a second card this
    script publishes, and `.frontend`: the same 9 chats through HTTP, each
    a 200 with well-formed SSE, its tokens the in-process phase path's or
    parting at a near-tie (MOE_TIE_TOL); the worker's graphs replayed and
    its launches K1-K4 > 0, K5 = K6 = 0 (its `_sys.stats` scrape)
 8i. the engine's flight recorders (`engine/profiler.py`,
    `engine/memory.py`) at Llama-3-8B bf16, on phase 8's weights drawn
    again: on the phase path and then the ragged path (batch 8, 2048
    pages, prefill all), an unarmed engine and one with DYN_STEP_PROFILE
    and DYN_MEM_LEDGER armed (and DYN_TRACE and DYN_AUDIT: each request
    one trace with its four engine stages, one audit record per HTTP
    chat) serve the same 4 seeded greedy chats
    (RECORDER_PROMPT_LENS tokens, 16 out) all in flight: streams identical
    token for token, the same graph captures, replays, rounds and kernel
    launches (K1-K4 phase, K1 K2 ragged, counts zeroed before each run),
    every recorded dispatch a graph run; per entry the dispatches, good
    and work tokens, padded share, host seconds, gap share of the wall and
    captures; the ledger's `weights` == `params_footprint` == the
    parameters' bytes and `kv_pool` == the K/V caches' bytes, exactly, the
    device figures, workspace by (entry, shape), residual and headroom.
    Then the armed phase engine as `run in=http` deploys it (one runtime,
    the frontend's /debug routes reading its recorders): 3 streamed chats,
    GET /debug, /debug/profile (+ ?format=chrome), /debug/memory,
    /debug/kv, /debug/router all 200; /debug/profile?capture_s=2 while
    the same chats stream again (cleared prefix cache: the same shapes)
    and one eager KV gather runs: the torch.profiler trace's kernels by
    class (the gather's must show; the replays' kernels or their
    cudaGraphLaunch calls); the dispatch watchdog (60 s) over it: its
    longest stall, 0 trips. Last, a child process builds a 2-layer
    Llama-3-8B-width engine with the ledger armed and DYN_OOM_EXIT set,
    serves a short chat, caps its caching allocator OOM_MARGIN above its
    reservation and sends a 2000-token prompt: exit 45 and a crash file
    whose triggering dispatch is "prefill" 1x512x1, with its last
    snapshot, step tail and `format_oom_attribution`. (8f arms the ledger
    on its engines and prints the KVBM providers' peaks.)
 8k. the admission and control planes (`tenancy/`, `serving_classes/`,
    `control/`) at Llama-3-8B bf16 on phase 8's weights: first an unarmed
    phase engine (batch 8, ADMISSION_PAGES pages, prefill all) serves
    wave 1's 16 chats (and a 32-token standard chat) in process, as the
    frontend's preprocessor renders them. Then the same engine config
    armed with DYN_TENANCY (gold weight 3; bronze weight 1 and a KV page
    budget of two requests' pages, decode growth included; capped: a
    token bucket that admits one request and refuses the next), DYN_CLASSES
    (the three default classes, brownout hold 1 s, recover 3 s),
    DYN_CONTROL=all every 0.5 s, DYN_STEP_PROFILE and DYN_KV_LIFECYCLE,
    served behind `start_frontend` in one runtime (run in=http's wiring,
    kv routing; the SLO loop parked: random weights feed it nothing).
    Wave 1: 8 bronze then 8 gold streamed greedy chats (16 tokens, top-8
    logprobs) queued while the engine's device lock is held, then
    released: the first 8 admissions hold 6 +- 1 gold (FIFO would admit 8
    bronze), bronze's live KV pages never above its budget while gold
    runs (polled), capped's second chat a 429 with Retry-After and the
    engine's arrivals unmoved; every 200 stream equal to the unarmed
    engine's or parting at a near-tie (BF16_TIE_TOL). Wave 2, the
    brownout, walked up through the machine's SLO entry point (the call
    the frontend's SLO loop makes, one `breach` of ttft:interactive per
    hold): at stage 1 a batch chat is a 503 with Retry-After equal to
    recover_s and an interactive chat a 200; at stage 2 a standard chat
    asking 64 tokens gets at most 32; at stage 3 the engine's spec_shrink
    is set (inert: no draft); an `ok` then lets the control plane's tick
    walk it back to 0 one stage per recover_s (the first step too: the
    machine and the plane share one clock), each step in /debug/control's
    action ring, all six transitions on the brownout_events subject and
    counted in /debug/classes, /fleet/status carrying the brownout and
    control blocks. Wave 3, meanwhile: wave 1's chats again over the small
    pool until the KV lifecycle recorder counts premature evictions; the
    KVBM tuner's watermark actions (step 0.01, floor 0.80, each with its
    evidence window; the engine's watermark equal to the last action's
    `to`) and the bucket autotuner's proposals (0: the engine labels a
    prefill (width, tokens, aligned), and the tuner takes two-dim labels
    only). Then its mechanism by hand: 8 in-process prompts of
    RUNG_PROMPT_LENS tokens run in the 384 bucket; a rung of RUNG is
    proposed to the engine's ladder while a long request decodes; the
    scheduler adopts it at its safe point; the same 8 prompts run at the
    new shape (its first dispatch warms up, captures and replays; a third
    pass replays), the prefill padding share falls, and the streams equal
    those before the rung or part at a near-tie. Printed: the tenant and
    class tables, the transitions with their times, the control actions,
    the rung's captures with seconds, the longest queue wait during them,
    each wave's wall, the launch counts (K1-K4 > 0).
 9. quantized main path: every other request of the batch (5; cut since
    8g was added) on the phase path through
    `build_torch_engine(quantize="w8a8")`, then `quantize="int4"` (the
    same random weights, quantized by the engine): w8a8 launches K5 and
    not K6, int4 K6 and not K5, both K1, K2, K3, K4; the phase path's
    graphed entries captured and replayed; greedy determinism; every
    projection held as int8 / packed int4 only (resident weight bytes
    printed per mode); one bare decode_step
    launches its GEMM exactly 4 x 32 times (q/k/v and gate/up grouped)
10. kernel path vs plain path at 8B: one mixed ragged round and one
    mixed_prefill_decode step in bf16, and one mixed_prefill_decode step
    per quantized mode (logits within a stated tolerance)
11a. graph replays at 8B: each bare step of phase 11 (the ragged decode
    and mixed rounds in bf16; the phase path's "prefill" at bp 1 and 8, T
    512, its "mixed_step" and its "sample_first" in bf16; the 8-step burst
    in bf16, w8a8, int4 and int8) captured in a CUDA graph through
    `engine/graphs.py` and replayed on a copy of the caches: bit-identical
    with the eager step on the same inputs (every output, both caches
    outside page 0); likewise one bare 8-lane spec burst of the 8B target
    and the 1B draft (gamma 4, 8 iterations) on copies of both cache
    pairs
11. profiles at 8B: host wall time (with the one sync) and device busy time
    (torch.profiler's CUDA kernels and copies) of a bare ragged decode
    round, a bare ragged mixed round, the phase path's bare prefill rounds,
    mixed step and first-token sampling, a bare 8-step decode burst
    (bf16, w8a8, int4 and int8: W8A16, cuBLAS over weights converted to
    bf16 on every call, not a main-path cell; each eager step profiled
    EAGER_PROFILE_REPS times: cut from 5 since 8c's parser run was
    added, and not at all since 8j was added: eager walls only), device
    time by kernel class and device ops per step; beside each, the same
    step replayed
    from its graph (host wall, device busy, the replay timed with CUDA
    events too, device ops; the bf16 graphed steps profiled
    GRAPH_PROFILE_REPS times: cut from 5 since 8c, 8d, 8f and 8i check
    the request tracer) and the graph pool's bytes; the bare spec
    burst replayed only (eager, it issues tens of thousands of launches:
    cut since 8g was added); each path's phase-7 batch's milliseconds
    per dispatch (the engine batches traced once more: cut since 8j was
    added; the ragged path's since 8g, the phase path's first batch since
    8h); the quantized bursts'
    eager and graphed runs profiled QUANT_PROFILE_REPS times (cut from 2
    and 5 since 8h was added, and to none since 8k was added: walls, the
    11a check and the replays' CUDA-event times only)
12. kernel path vs plain path at 2 layers, full width, fp32: greedy
    streams over 16 steps x 3 requests across phase-kernel, phase-plain,
    ragged-kernel and ragged-plain — identical unquantized, and under
    w8a8 and int4 identical up to partings at near-ties (A8_TIE_TOL); per
    mode also phase 8b's constrained batch (top-8 logprobs) on the phase
    path, kernels vs plain: every lane inside its grammar, the streams
    equal up to partings at near-ties (BF16_TIE_TOL)
13. numbers: at the main paths' shapes, each kernel held against its
    plain version once more, then kernel / plain / library times (CUDA
    events around device work only: the card sleeps while the host queues
    the launches; median of 20, L2 flushed before each by reading 64 MB,
    the kernels also after a 64 MB write as in older records), the
    empty-kernel floor under the same flush, K2 and K3 also per launch in
    a run of 32 (one per layer, 32 cache pairs), bounds from bytes and
    operations; K5/K6 at the four projection shapes at M = 8 (burst) and
    512 (chunk) beside torch._int_mm + epilogue and bf16 torch.matmul; K1
    on the phase path's widest chunk round beside the plain prefill
    attention and scaled_dot_product_attention on pre-gathered K/V (its
    causal mask), K1's decode round and K4's burst beside the same call
    under a padding mask (the mixed round's ragged mix has no single
    library call; its library column stays null); the
    KV gather of 66 pages x 32 layers beside its plain version and the
    per-layer index_select loop; K4 on the burst's lanes and K1 on the
    decode round at the draft's geometry (D 64) beside their plain
    versions and SDPA; each path's and mode's output tok/s and TTFT p50,
    the phase path's steady batch apart

Each phase's seconds are printed on a `[phase-time]` line.

The last three lines of stdout are the kernels JSON, the nvidia-smi line
and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import contextlib
import gc
import itertools
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Llama-3-8B's published shape (models/llama.py LlamaConfig.llama3_8b)
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 128256,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 8192, "tie_word_embeddings": False,
}
# Llama-3.2-1B's published shape (meta-llama/Llama-3.2-1B config.json), the
# draft of phase 8g. The published config also has rope_scaling
# {"rope_type": "llama3", ...}, which neither package reads (both apply
# plain RoPE at rope_theta): with it left out, this draft differs from the
# published model in its rotary frequencies
DRAFT_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "vocab_size": 128256,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": True,
}
# phase 8g's speculative decoding: draft tokens per iteration, iterations
# per burst
SPEC_GAMMA, SPEC_ITERS = 4, 8
# card peaks (NVIDIA data sheets, dense): HBM bytes/s, bf16 and fp32 flop/s,
# int8 op/s
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
         "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 1671e12)}
# K1 in bf16 vs the plain version (fp32 softmax): |got - want| <=
# atol + rtol * |want|. Both sides round the output to bf16 once (the
# kernel's P·V takes P as a bf16 head and tail, ~16 bits; a kernel that
# rounded P to bf16 once also met these bounds): two bf16 ulps relative
# (rtol), and atol 2^-8 for rows whose output is small beside its V
# values.
K1_BF16_TOL = {"atol": 4e-3, "rtol": 1.6e-2}
K1_FP32_TOL = {"atol": 2e-5, "rtol": 2e-5}   # the reference's parity check
# K1 in bf16 with q = 0: every score is 0, so P = 1 is exact in bf16 and
# each row's output is the fp32 mean of the V rows it can see, rounded to
# bf16 once. Held against the plain version in fp32 to half a bf16 ulp
# (2^-8 relative): one key too many or too few moves a row's mean by about
# |v| / context, above that for every context these checks use
K1_UNIFORM_TOL = {"atol": 1e-5, "rtol": 4e-3}
# K4 against its plain version: fp32 at the reference's kernel-parity
# tolerance; bf16 as K1 (K4's bf16 path is K1's core at one row per lane,
# with the same P·V); q = 0 as K1
K4_FP32_TOL = K1_FP32_TOL
K4_BF16_TOL = K1_BF16_TOL
K4_UNIFORM_TOL = K1_UNIFORM_TOL
# 8B mixed round / mixed step, kernel vs plain path in bf16: the attention
# outputs differ by bf16 roundings that 32 layers carry to the logits
# (measured 0.094 at max |logit| 4.8 on an H100 80GB HBM3, 700 W)
LOGITS_BF16_TOL = 0.15
# Greedy bf16 8B streams of one request, phase path vs ragged path: the two
# attend through different bf16 kernels (plain prefill attention + K4 vs
# K1), which move each logprob by up to what phase 10 measures between
# kernel and plain paths (0.1245 for the mixed step's decode top-8
# logprobs on an H100 80GB HBM3, 700 W; bounded there by LOGITS_BF16_TOL).
# Where the streams part, both runs' logprobs of the two tokens moved by at
# most that and their order flipped, so each run's margin is at most twice
# it
BF16_TIE_TOL = 2 * LOGITS_BF16_TOL
# The same step under w8a8 / int4. The A8 GEMMs are bit-identical with
# their plain versions, but each bf16 rounding difference in attention that
# crosses an int8 step of an activation row becomes a whole step (~1/127
# of the row's absmax), so the differences grow past the bf16 path's
# (measured 0.156 for w8a8's decode top-8 logprobs beside bf16's 0.0935 on
# an H100 80GB HBM3, 700 W)
LOGITS_A8_TOL = 0.4
PLAIN_ROW_BLOCK = 64      # the plain K1 gathers whole contexts per row
# Greedy fp32 streams under w8a8/int4 across paths: the A8 rounding is
# discontinuous, so an fp32 difference of one ulp in attention (kernel vs
# plain, phase vs ragged) now and then rounds an activation to the next
# int8 step, and the 2-layer full-width model's logits move by a few
# hundredths. Two streams may then part at a greedy near-tie: the streams
# must agree before it, and there each run must rank the other's token
# within this many nats of its own (partings measured at 0.020-0.054 nats
# on an H100 80GB HBM3, 700 W; a wrong product moves logits by O(1))
A8_TIE_TOL = 0.15
# the card spins this many cycles (~1 ms) before each timed launch, so the
# host has queued the launch before the start event fires and the events
# read device time only
SLEEP_CYCLES = 2_000_000
# ~10 ms: a run of 32 layers' launches (up to 4 host ops each) is queued
# before the start event fires
RUN_SLEEP_CYCLES = 20_000_000
# Llama-3-8B's projections (K, N): wq/wo, wk/wv, gate/up, down
PROJECTIONS = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
               "gate/up": (4096, 14336), "down": (14336, 4096)}
QUANT_MODES = ("w8a8", "int4")
# K5/K6 activation rows held against the plain versions: both sides of
# every design edge (int4_mm.design)
A8_MS = (1, 8, 9, 16, 17, 40, 64, 65, 512, 600)
GEMM_OF = {"w8a8": "w8a8_matmul", "int4": "int4_matmul"}
K2_LAYOUTS = ("contiguous", "fused", "heads")
K3_LAYOUTS = ("chunk", "contiguous")
N_LAYER_RUN = 32          # Llama-3-8B's layers: one KV store each per step
# the phase path's graphed entries, every one replayed in phase 8's batch
PHASE_ENTRIES = ("prefill", "mixed_step", "sample_first", "decode_burst")


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> tuple[str, tuple[float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(torch, fn, reps: int = 20, flush=None,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median of `reps` single launches timed with CUDA events; `flush`
    (outside the timed window) evicts L2 first, and the card then sleeps
    `sleep_cycles` so that the events time the device work and not the
    host's enqueue of it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_run_ms(torch, fns, reps: int = 20, flush=None) -> float:
    """A run of launches as a step issues them (one per layer, say): the
    median over `reps` of the run's device time after one flush, over the
    number of launches. The card sleeps RUN_SLEEP_CYCLES first, long
    enough for the host to queue the whole run."""
    return time_ms(torch, lambda: [fn() for fn in fns], reps, flush,
                   RUN_SLEEP_CYCLES) / len(fns)


def l2_flushes(torch, dev) -> dict:
    """{"read": ..., "write": ...}: two ways to evict the 50 MB L2 before
    a timed launch. The write flush (zeroing 64 MB) leaves dirty lines
    that the timed work then pays to write back; the read flush (an amax
    over the same 64 MB into one scalar) leaves only clean lines."""
    buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    words = buf.view(torch.int32)
    return {"read": words.amax, "write": buf.zero_}


def k2_rows(torch, gen, dev, b, kvh, d, layout, dtype=None):
    """(B, KVH, D) K2 rows laid out as a caller may hand them: "contiguous"
    (a projection's output viewed as heads, what every step passes),
    "fused" (a slice of a wider (B, 3·KVH·D) projection output), "heads"
    (a head-major tensor transposed)."""
    dtype = dtype or torch.bfloat16
    if layout == "fused":
        wide = torch.randn(b, 3 * kvh * d, generator=gen).to(dev, dtype)
        return wide[:, kvh * d:2 * kvh * d].view(b, kvh, d)
    if layout == "heads":
        return torch.randn(kvh, b, d, generator=gen).to(dev, dtype) \
            .transpose(0, 1)
    return torch.randn(b, kvh * d, generator=gen).to(dev, dtype) \
        .view(b, kvh, d)


def k3_blocks(torch, gen, dev, m, kvh, p, d, layout, dtype=None):
    """(M, KVH, P, D) K3 blocks: "chunk" (a token-major (M·P, KVH, D)
    chunk K/V viewed per page and permuted, what `_chunk_kv_writer`
    passes) or "contiguous"."""
    dtype = dtype or torch.bfloat16
    if layout == "chunk":
        return torch.randn(m * p, kvh, d, generator=gen).to(dev, dtype) \
            .view(m, p, kvh, d).permute(0, 2, 1, 3)
    return torch.randn(m, kvh, p, d, generator=gen).to(dev, dtype)


def attention_mix(torch, gen, n_pages: int, page_size: int, max_pages: int,
                  decode_ctx: list[int], chunks: list[tuple[int, int]],
                  n_pad: int):
    """Flat rows of one ragged round: one decode row per context length
    (attending positions < ctx), chunk rows (start, length), padding rows.
    Each lane gets its own pages (never page 0). Returns (qpos, lanes,
    tables) int32 on the CPU."""
    lanes_n = len(decode_ctx) + len(chunks)
    tables = torch.zeros(lanes_n, max_pages, dtype=torch.int32)
    free = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    qpos, lanes = [], []
    for lane, ctx in enumerate(decode_ctx):
        need = -(-ctx // page_size)
        tables[lane, :need] = torch.tensor(free[:need])
        free = free[need:]
        qpos.append(ctx - 1)
        lanes.append(lane)
    for j, (start, n) in enumerate(chunks):
        lane = len(decode_ctx) + j
        need = -(-(start + n) // page_size)
        tables[lane, :need] = torch.tensor(free[:need])
        free = free[need:]
        qpos += list(range(start, start + n))
        lanes += [lane] * n
    qpos += [-1] * n_pad
    lanes += [0] * n_pad
    return (torch.tensor(qpos, dtype=torch.int32),
            torch.tensor(lanes, dtype=torch.int32), tables)


def bound(nbytes: float, flops: float, flop_rate: float, peaks):
    """max(bytes / HBM rate, flops / peak rate) in ms, and which binds."""
    t_bytes, t_ops = nbytes / peaks[0], flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(torch, qpos, lanes, tables, h, kvh, d, p, esize, peaks):
    """Least time for K1's work on these inputs. Bytes: q of the valid
    rows, every output row (padding rows write zeros), every qpos, the
    valid rows' lanes, the table entries of the pages those rows can see,
    and those pages' K and V once each. Flops: 4 per (head, visible key,
    d)."""
    valid = qpos >= 0
    ctx = (qpos[valid].long() + 1)
    pages = set()
    for lane, c in zip(lanes[valid].tolist(), ctx.tolist()):
        pages.update((lane, j) for j in range(-(-c // p)))
    unique = {int(tables[lane, j]) for lane, j in pages}
    rows, n_valid = qpos.numel(), int(valid.sum())
    nbytes = ((n_valid + rows) * h * d * esize
              + 2 * len(unique) * kvh * p * d * esize
              + 4 * rows + 4 * n_valid + 4 * len(pages))
    flops = 4 * h * d * int(ctx.sum())
    return bound(nbytes, flops, peaks[1] if esize == 2 else peaks[2], peaks)


def k2_bound_ms(page_ids, kvh, d, esize, peaks):
    """Least time for K2's work: every row's page id and offset; K and V
    of the rows that land outside scratch page 0 read and written once,
    plus one page-0 row (all padding rows write the same slot)."""
    n_pad = int((page_ids == 0).sum())
    kept = page_ids.numel() - n_pad + min(n_pad, 1)
    return bound(4 * kept * kvh * d * esize + 8 * page_ids.numel(), 0.0,
                 peaks[1], peaks)


def k3_bound_ms(page_ids, kvh, p, d, esize, peaks):
    """Least time for K3's work: every slot's page id; the K and V pages of
    the slots that land outside scratch page 0 read and written once, plus
    one page-0 slot (all padding slots write the same page)."""
    n_pad = int((page_ids == 0).sum())
    kept = page_ids.numel() - n_pad + min(n_pad, 1)
    return bound(4 * kept * kvh * p * d * esize + 4 * page_ids.numel(), 0.0,
                 peaks[1], peaks)


def a8_bound_ms(m, k, n, bits, esize, peaks):
    """Least time for K5's (bits 8) or K6's (bits 4) work: x read once,
    the weights (K·N·bits/8 bytes) and scales read once, y written once;
    2·M·K·N int8 operations at the int8 dense peak."""
    nbytes = m * k * esize + k * n * bits // 8 + 4 * n + m * n * esize
    return bound(nbytes, 2.0 * m * k * n, peaks[3], peaks)


def k4_bound_ms(lengths, tables, h, kvh, d, p, esize, peaks):
    """Least time for K4's work on these inputs. Bytes: q of the lanes with
    a length, every output lane (padding lanes write zeros), the lengths,
    the table entries of the pages the lanes can see and those pages' K and
    V once each. Flops: 4 per (head, visible key, d)."""
    lens = [int(x) for x in lengths.tolist()]
    pages = [(b, j) for b, n in enumerate(lens) for j in range(-(-n // p))]
    unique = {int(tables[b, j]) for b, j in pages}
    n_valid = sum(1 for n in lens if n > 0)
    nbytes = ((n_valid + len(lens)) * h * d * esize + 4 * len(lens)
              + 4 * len(pages) + 2 * len(unique) * kvh * p * d * esize)
    flops = 4 * h * d * sum(lens)
    return bound(nbytes, flops, peaks[1] if esize == 2 else peaks[2], peaks)


def decode_case(torch, gen, dev, dtype, lengths, n_pages, max_pages, h, kvh,
                p, d, zero_q=False):
    """K4 inputs: one query per lane, each lane its own pages (never page
    0). Returns (q, k_pages, v_pages, lengths, tables) on `dev`."""
    b = len(lengths)
    tables = torch.zeros(b, max_pages, dtype=torch.int32)
    free = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    for i, n in enumerate(lengths):
        need = -(-n // p)
        tables[i, :need] = torch.tensor(free[:need], dtype=torch.int32)
        free = free[need:]
    q = torch.zeros(b, h, d) if zero_q else torch.randn(b, h, d,
                                                        generator=gen)
    kp = torch.randn(kvh, n_pages, p, d, generator=gen)
    vp = torch.randn(kvh, n_pages, p, d, generator=gen)
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(lengths, dtype=torch.int32).to(dev), tables.to(dev))


def sdpa_decode(torch, attention, q, kp, vp, lengths, tables):
    """The library yardstick of a decode round (one query per lane, lane
    i attending positions < lengths[i]): scaled_dot_product_attention on
    K/V gathered per lane beforehand (contiguous; the gather not timed)
    under a padding mask. Returns the call."""
    n_vis = -(-int(lengths.max()) // kp.shape[2])
    kg = attention._gather_pages(kp, tables[:, :n_vis])
    vg = attention._gather_pages(vp, tables[:, :n_vis])
    s_pos = torch.arange(kg.shape[2], device=kg.device)
    mask = (s_pos[None, :] < lengths[:, None])[:, None, None]
    qt = q[:, :, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)[:, :, 0]

    return sdpa


def uniform_check(ragged, plain_k1, torch, kp, vp, qpos, lanes, tables,
                  h, label):
    """K1 in bf16 with q = 0 against the plain version in fp32 on the same
    (bf16-valued) pages: each row's output is the mean of the V rows it
    can see, so a dropped or extra key, page, tile step or split shows."""
    q = torch.zeros(qpos.numel(), h, kp.shape[-1], device=kp.device,
                    dtype=torch.bfloat16)
    got = ragged.ragged_paged_attention(q, kp, vp, qpos, lanes, tables)
    want = plain_k1(q.float(), kp.float(), vp.float(), qpos, lanes, tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **K1_UNIFORM_TOL)
    err = (got.float() - want).abs().max().item()
    log(f"[k1] {label} uniform attention (q = 0) bf16 vs fp32 plain: "
        f"max_abs_err {err:.3e} ({K1_UNIFORM_TOL})")


def graph_replay_check(torch, call, index, values, label):
    """`call()` (a bf16 K1 or K4 launch) captured once in a CUDA graph,
    then replayed after each of `values` is copied in place into the
    device tensor `index` (token_qpos or lengths): each replay must equal
    an eager call on the same inputs, so the kernel read nothing of
    `index` on the host when it was captured."""
    call()                              # the scratch exists before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for new in values:
        index.copy_(new)
        graph.replay()
        want = call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: the graph replay differs from an "
                                 f"eager call")
    del graph
    log(f"[graph] {label}: captured once, replayed with {len(values)} "
        f"in-place changes, equal to eager calls")


def blocked_plain_attention(ragged, torch):
    """The plain K1 over row blocks of PLAIN_ROW_BLOCK (its per-row
    context gather would not fit the card for a whole round)."""
    def run(q, kp, vp, qpos, lanes, tables):
        outs = [ragged.ragged_attention_ref(
                    q[i:i + PLAIN_ROW_BLOCK], kp, vp,
                    qpos[i:i + PLAIN_ROW_BLOCK],
                    lanes[i:i + PLAIN_ROW_BLOCK], tables)
                for i in range(0, q.shape[0], PLAIN_ROW_BLOCK)]
        return torch.cat(outs) if outs else torch.empty_like(q)
    return run


def draft_geometry_checks(torch, gen, dev, kernels, attention, ragged,
                          plain_k1, n_pages: int, max_pages: int) -> dict:
    """Phases 3-6 at the draft's geometry (Llama-3.2-1B: H 32, KVH 8, D 64,
    P 16), bf16: K2 and K3 bit-exact outside page 0 on every source
    layout; K1 on a ragged mix and on decode rows, K4 on page-edge and long
    lanes, within K1_BF16_TOL / K4_BF16_TOL, padding rows and empty lanes
    exact zeros, and with q = 0 at the uniform tolerance. Then one K1 call
    at a verify round's shape (8 lanes x SPEC_GAMMA + 1 rows from
    unaligned cursors, D 128) against the plain version. Returns the max
    abs errors by kernel."""
    H, KVH, D, P = 32, 8, 64, 16
    dt = torch.bfloat16
    errs = {"k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0}
    kc = torch.randn(KVH, n_pages, P, D, generator=gen).to(dev, dt)
    vc = torch.randn(KVH, n_pages, P, D, generator=gen).to(dev, dt)
    B = 64
    slots = torch.randperm((n_pages - 1) * P, generator=gen)[:B]
    pages = (1 + slots // P).to(torch.int32)
    offs = (slots % P).to(torch.int32)
    pages[-6:], offs[-6:] = 0, 0
    pages, offs = pages.to(dev), offs.to(dev)
    for layout in K2_LAYOUTS:
        rows = [k2_rows(torch, gen, dev, B, KVH, D, layout) for _ in range(2)]
        want = (kc.clone(), vc.clone())
        kernels.paged_kv_write_ref(*want, *rows, pages, offs)
        got = (kc.clone(), vc.clone())
        kernels.paged_kv_write(*got, *rows, pages, offs)
        torch.cuda.synchronize()
        if not all(torch.equal(g[:, 1:], w[:, 1:])
                   for g, w in zip(got, want)):
            raise AssertionError(f"K2 at D {D} differs from its plain "
                                 f"version on {layout} sources")
    M = 40
    ids = (1 + torch.randperm(n_pages - 1, generator=gen)[:M]).to(
        torch.int32)
    ids[[5, 17, 30, 31, 39]] = 0
    ids = ids.to(dev)
    for layout in K3_LAYOUTS:
        blocks = [k3_blocks(torch, gen, dev, M, KVH, P, D, layout)
                  for _ in range(2)]
        want = (kc.clone(), vc.clone())
        kernels.paged_kv_write_pages_ref(*want, *blocks, ids)
        got = (kc.clone(), vc.clone())
        kernels.paged_kv_write_pages(*got, *blocks, ids)
        torch.cuda.synchronize()
        if not all(torch.equal(g[:, 1:], w[:, 1:])
                   for g, w in zip(got, want)):
            raise AssertionError(f"K3 at D {D} differs from its plain "
                                 f"version on {layout} blocks")
    log(f"[draft-geometry] K2 (B {B}, sources {K2_LAYOUTS}) and K3 (M {M}, "
        f"5 padding slots, blocks {K3_LAYOUTS}) at KVH {KVH} D {D} P {P} "
        f"bf16: bit-exact outside page 0")
    del got, want
    decode_ctx = [1, 17, 100, 511, 1024, 2047, 3000, 4096]
    for label, mix in (("mixed", (decode_ctx, [(1000, 100), (0, 60),
                                               (7, 25)], 12)),
                       ("decode", (decode_ctx, [], 2))):
        qpos, lanes, tables = (x.to(dev) for x in attention_mix(
            torch, gen, n_pages, P, max_pages, *mix))
        q = torch.randn(qpos.numel(), H, D, generator=gen).to(dev, dt)
        got = ragged.ragged_paged_attention(q, kc, vc, qpos, lanes, tables)
        want = plain_k1(q, kc, vc, qpos, lanes, tables)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **K1_BF16_TOL)
        if not torch.all(got[qpos < 0] == 0):
            raise AssertionError("K1 padding rows at D 64 are not zeros")
        err = (got.float() - want.float()).abs().max().item()
        errs["k1"] = max(errs["k1"], err)
        log(f"[draft-geometry] K1 {label} H {H} KVH {KVH} D {D} bf16 rows "
            f"{qpos.numel()}: max_abs_err {err:.3e} ({K1_BF16_TOL})")
        uniform_check(ragged, plain_k1, torch, kc, vc, qpos, lanes, tables,
                      H, f"D {D} {label}")
    for label, lens in (("edges", [1, 15, 16, 17, 32, 0, 33, 0]),
                        ("long", [0, 100, 511, 1024, 2047, 3000, 4096,
                                  4000])):
        args = decode_case(torch, gen, dev, dt, lens, n_pages, max_pages, H,
                           KVH, P, D)
        got = attention.paged_attention_decode(*args)
        want = attention.paged_attention_decode_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **K4_BF16_TOL)
        if not torch.all(got[args[3] == 0] == 0):
            raise AssertionError("K4 empty lanes at D 64 are not zeros")
        err = (got.float() - want.float()).abs().max().item()
        errs["k4"] = max(errs["k4"], err)
        zq = (torch.zeros_like(args[0]),) + args[1:]
        got = attention.paged_attention_decode(*zq)
        want = attention.paged_attention_decode_ref(
            *[a.float() if a.is_floating_point() else a for a in zq])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **K4_UNIFORM_TOL)
        log(f"[draft-geometry] K4 {label} H {H} KVH {KVH} D {D} bf16 lanes "
            f"{lens}: max_abs_err {err:.3e} ({K4_BF16_TOL}); q = 0 "
            f"{(got.float() - want).abs().max().item():.3e} "
            f"({K4_UNIFORM_TOL})")
        del args
    del kc, vc
    # a verify round: 8 lanes x (gamma + 1) rows from unaligned cursors
    g1, d8 = SPEC_GAMMA + 1, 128
    starts = [44, 73, 133, 233, 383, 653, 853, 1033]
    tables = torch.zeros(8, max_pages, dtype=torch.int32)
    free = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    for i, st in enumerate(starts):
        need = -(-(st + g1) // P)
        tables[i, :need] = torch.tensor(free[:need], dtype=torch.int32)
        free = free[need:]
    qpos = torch.tensor([st + j for st in starts for j in range(g1)],
                        dtype=torch.int32).to(dev)
    lanes = torch.tensor([i for i in range(8) for _ in range(g1)],
                         dtype=torch.int32).to(dev)
    tables = tables.to(dev)
    kp = torch.randn(KVH, n_pages, P, d8, generator=gen).to(dev, dt)
    vp = torch.randn(KVH, n_pages, P, d8, generator=gen).to(dev, dt)
    q = torch.randn(qpos.numel(), H, d8, generator=gen).to(dev, dt)
    got = ragged.ragged_paged_attention(q, kp, vp, qpos, lanes, tables)
    want = plain_k1(q, kp, vp, qpos, lanes, tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **K1_BF16_TOL)
    err = (got.float() - want.float()).abs().max().item()
    errs["k1"] = max(errs["k1"], err)
    log(f"[draft-geometry] K1 at a verify round (8 lanes x {g1} rows from "
        f"cursors {starts}, D {d8}) bf16: max_abs_err {err:.3e} "
        f"({K1_BF16_TOL})")
    return errs


def compare_streams(want: list, got: list, label: str,
                    tol: float = BF16_TIE_TOL) -> list:
    """(tokens, top-k) per request, `got` against `want`: equal, or parting
    at a bf16 near-tie within `tol` (BF16_TIE_TOL by default; each printed
    with its step and gap); a length mismatch without a parting raises.
    Returns the partings [(request, step, gap)]."""
    partings = []
    for r, ((ta, ka), (tb, kb)) in enumerate(zip(want, got)):
        n = min(len(ta), len(tb))
        if next((i for i in range(n) if ta[i] != tb[i]), None) is None:
            if len(ta) != len(tb):
                raise AssertionError(f"{label}, request {r}: {len(tb)} "
                                     f"tokens against {len(ta)}")
            continue
        for _, s, g in stream_partings([(ta[:n], ka[:n])],
                                       [(tb[:n], kb[:n])], tol):
            partings.append((r, s, g))
            log(f"[{label}] request {r} parts at step {s} of {len(tb)}: "
                f"tokens {ta[s]} vs {tb[s]}, logprob gap {g:.4f} nats (tie "
                f"tolerance {tol}); identical before it")
    return partings


# a batch request's fields beside its text: greedy, the top-8 logprobs of
# each token, logprobs tokens as "token_id:<id>" (random weights emit
# tokens the byte tokenizer decodes to nothing) and one chunk per engine
# output, so a client sees each token as it arrives
GREEDY_FIELDS = {"temperature": 0.0, "logprobs": True, "top_logprobs": 8,
                 "return_tokens_as_token_ids": True}


def write_jobs(path: str, seed: int) -> str:
    """The main path's batch: 10 greedy chat prompts of 16..1500 bytes,
    each token's top-8 logprobs returned (GREEDY_FIELDS)."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for n in (16, 40, 100, 200, 350, 600, 800, 1000, 1250, 1500):
            text = "".join(rng.choice("abcdefghij klmnop qrstuv wxyz.,")
                           for _ in range(n))
            f.write(json.dumps({"text": text, **GREEDY_FIELDS}) + "\n")
    return path


def token_ids_of(entries: list) -> tuple:
    """(token ids, top-k [[id, logprob], ...] per token) from chat
    logprobs entries rendered under return_tokens_as_token_ids."""
    def tid(s: str) -> int:
        if not s.startswith("token_id:"):
            raise AssertionError(f"logprobs token {s!r} is not an id")
        return int(s[len("token_id:"):])

    return ([tid(e["token"]) for e in entries],
            [[[tid(a["token"]), a["logprob"]] for a in e["top_logprobs"]]
             for e in entries])


class Service:
    """One of the port's CLIs as a subprocess (never a fork of this
    process, which has initialised CUDA): stdout lines read by a thread,
    stderr to a file."""

    def __init__(self, work: str, name: str, *args: str,
                 label: str = "", env: dict | None = None) -> None:
        import queue
        import threading

        env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
        env.pop("DYN_ATTENTION_IMPL", None)       # the phase path
        self.name = label or name
        self.err_path = os.path.join(work, f"{self.name}.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"dynamo_tpu_torch.{name}", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True)
        self.lines = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)

    def stderr_tail(self, n: int = 3000) -> str:
        with open(self.err_path) as f:
            return f.read()[-n:]

    def wait_line(self, prefix: str, timeout: float) -> str:
        import queue

        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                if self.proc.poll() is not None:
                    break
                continue
            if line.startswith(prefix):
                return line.split()[1]
        raise AssertionError(
            f"{self.name} gave no {prefix} line (exit code "
            f"{self.proc.poll()}); stderr: {self.stderr_tail()}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._reader.join(10)
        self._err.close()


def http_chat_stream(port: int, body: dict,
                     headers: dict | None = None) -> dict:
    """One streamed chat request through the frontend (`headers` beside
    its content type): its tokens, top-k logprobs, finish reason, and
    client-side seconds to the first token chunk and to `data: [DONE]`.
    Raises on anything but HTTP 200 with well-formed SSE that ends in
    [DONE] after a finish_reason."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        if r.status != 200 or r.getheader("Content-Type") != \
                "text/event-stream":
            raise AssertionError(f"HTTP {r.status} "
                                 f"{r.getheader('Content-Type')}: "
                                 f"{r.read()[:500]!r}")
        entries, first, done, finish, usage = [], None, None, None, None
        rid, text = None, []
        while True:
            line = r.readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            if not line.startswith(b"data: ") or done is not None:
                raise AssertionError(f"malformed SSE line {line[:200]!r}")
            if line == b"data: [DONE]":
                done = time.perf_counter() - t0
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise AssertionError(f"SSE error event: {chunk}")
            rid = chunk.get("id", rid)
            for ch in chunk["choices"]:
                got = (ch.get("logprobs") or {}).get("content") or []
                if got and first is None:
                    first = time.perf_counter() - t0
                entries.extend(got)
                text.append((ch.get("delta") or {}).get("content") or "")
                finish = ch.get("finish_reason") or finish
            usage = chunk.get("usage") or usage
    finally:
        conn.close()
    if done is None or finish is None or usage is None:
        raise AssertionError(f"stream ended without [DONE] / finish_reason "
                             f"/ usage: {done}, {finish}, {usage}")
    toks, tops = token_ids_of(entries)
    if usage["completion_tokens"] != len(toks) or first is None:
        raise AssertionError(f"{usage} for {len(toks)} tokens")
    return {"tokens": toks, "tops": tops, "finish": finish,
            "ttft_s": first, "elapsed_s": done, "t0": t0,
            "prompt_tokens": usage["prompt_tokens"], "id": rid,
            "text": "".join(text), "usage": usage}


def latency_summary(rows: list, wall: float) -> str:
    """TTFT p50/p99, ITL p50 ((elapsed - ttft) / (tokens - 1) per
    request) and output tok/s of a batch."""
    ttft = sorted(r["ttft_s"] for r in rows)
    itl = [(r["elapsed_s"] - r["ttft_s"]) / (r["n"] - 1) for r in rows
           if r["n"] > 1]
    p99 = ttft[min(len(ttft) - 1, math.ceil(0.99 * len(ttft)) - 1)]
    return (f"TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, p99 "
            f"{p99 * 1e3:.1f} ms; ITL p50 {statistics.median(itl) * 1e3:.2f}"
            f" ms; {sum(r['n'] for r in rows) / wall:.1f} output tok/s "
            f"({len(rows)} requests in {wall:.2f} s)")


def prometheus_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    raise AssertionError(f"no {series} in the scrape")


async def worker_scrape(store_url: str) -> dict:
    """Each worker's metrics registry (Prometheus text) through its
    transport's `_sys.stats` scrape, found through the coordinator:
    {instance id: text}."""
    from dynamo_tpu_torch.runtime.component import INSTANCE_PREFIX, Instance
    from dynamo_tpu_torch.runtime.store import connect_store
    from dynamo_tpu_torch.runtime.transport import (
        TransportClient,
        TransportServer,
    )

    store = await connect_store(store_url)
    client = TransportClient()
    out = {}
    try:
        for kv in await store.get_prefix(INSTANCE_PREFIX):
            inst = Instance.from_json(kv.value)
            items = [x async for x in client.request(
                inst.address, TransportServer.STATS_SUBJECT, {})]
            out[inst.instance_id] = items[0]["client"]["metrics"]
    finally:
        await client.close()
        await store.close()
    return out


def _http_post(port: int, path: str, body: dict) -> tuple[int, dict]:
    """One unary JSON request: (status, decoded body)."""
    status, _, raw = _http_raw(port, path, body)
    return status, json.loads(raw)


def serving_extras(torch, port: int, model, llama) -> None:
    """Phase 8c's extras against the running worker: one /v1/embeddings
    request (a 300-token prompt as ids), its vector held to the in-process
    `embed_batch` of phase 8's weights on the same padded bucket at
    cosine >= 0.9999; one n = 2 chat and one /v1/responses request, each
    well-formed."""
    ids = [(7 * i + 3) % 256 for i in range(300)]
    t0 = time.perf_counter()
    status, emb = _http_post(port, "/v1/embeddings",
                             {"model": "llama3-8b", "input": ids})
    emb_s = time.perf_counter() - t0
    if status != 200 or len(emb.get("data", ())) != 1:
        raise AssertionError(f"/v1/embeddings answered {status}: {emb}")
    got = torch.tensor(emb["data"][0]["embedding"], dtype=torch.float64)
    bucket = 16
    while bucket < len(ids):
        bucket *= 2
    toks = torch.zeros(1, bucket, dtype=torch.int32)
    toks[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    want = llama.embed_batch(model, toks.cuda(), torch.tensor(
        [len(ids)], dtype=torch.int32).cuda())[0].double().cpu()
    cos = float(got @ want / (got.norm() * want.norm()))
    if not (got.numel() == model.cfg.hidden_size and cos >= 0.9999
            and emb["usage"]["prompt_tokens"] == len(ids)):
        raise AssertionError(f"/v1/embeddings: dim {got.numel()}, cosine "
                             f"{cos} with the in-process embed_batch")
    status, chat = _http_post(port, "/v1/chat/completions", {
        "model": "llama3-8b", "n": 2, "max_tokens": 8, "temperature": 0.8,
        "seed": 3, "messages": [{"role": "user", "content": "two ways"}]})
    if status != 200 or [c["index"] for c in chat["choices"]] != [0, 1] \
            or any(c["finish_reason"] not in ("length", "stop")
                   for c in chat["choices"]) \
            or chat["usage"]["completion_tokens"] < 2:
        raise AssertionError(f"n = 2 chat answered {status}: {chat}")
    status, resp = _http_post(port, "/v1/responses", {
        "model": "llama3-8b", "input": "respond", "max_output_tokens": 8,
        "temperature": 0})
    if status != 200 or resp.get("status") != "completed" \
            or resp["output"][0]["type"] != "message" \
            or resp["usage"]["output_tokens"] < 1:
        raise AssertionError(f"/v1/responses answered {status}: {resp}")
    log(f"[serve] /v1/embeddings of a {len(ids)}-token input: "
        f"{got.numel()} floats in {emb_s:.3f} s, cosine {cos:.7f} with the "
        f"in-process embed_batch; n = 2 chat: 2 choices, "
        f"{chat['usage']['completion_tokens']} completion tokens; "
        f"/v1/responses: status {resp['status']}, "
        f"{resp['usage']['output_tokens']} output tokens")


# phase 8c's status plane: the worker's canary interval, the dispatch
# watchdog's stall threshold (above the longest single dispatch: a first
# batch captures graphs inside its dispatches), the frontend's adaptive
# idle margin
HEALTH_INTERVAL_S = 1.0
WATCHDOG_STALL_S = 60.0
ADAPTIVE_IDLE_MARGIN = 10.0
ITL_WAVE = 10
# phase 8c's observability layer: both processes publish a snapshot each
# second; the frontend's SLO monitor holds a TTFT objective no request
# meets and an ITL objective none misses, so their states are known
TELEMETRY_INTERVAL_S = 1.0
SLO_TTFT_S = 0.001
SLO_ITL_S = 60.0
SLO_CHECK_INTERVAL_S = 1.0
# the engine stages of one traced request (runtime/tracing.py)
ENGINE_STAGES = ("engine.queue_wait", "engine.prefill.chunk",
                 "engine.prefill", "engine.decode")


def serving_phase(torch, smi: str, work: str, ckpt: str, jobs: str,
                  in_proc: dict, model, llama) -> None:
    """Phase 8c: the port as a deployment on the card. The coordinator,
    a worker serving the phase-8 checkpoint (random init, seed 0) on cuda
    and the OpenAI frontend run as three processes; phase 8's 10 chat
    requests go to the frontend all in flight, streamed. Every stream must
    be a well-formed SSE 200 ending in [DONE], its tokens those of the
    in-process phase-path batch for the same request (or parting at a
    bf16 near-tie within BF16_TIE_TOL). Prints TTFT, ITL and tok/s through
    HTTP beside the in-process batch's, the frames the frontend received,
    and the worker's CUDA-graph captures and replays. Then the worker
    answers the serving extras (`serving_extras`)."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.runtime.distributed import free_port

    free, total = torch.cuda.mem_get_info()
    log(f"[serve] before the deployment starts: {free / 2**30:.1f} GiB free "
        f"of {total / 2**30:.1f} GiB on the card")
    with open(jobs) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    services = []
    sys_port, fe_sys = free_port(), free_port()
    # the observability layer armed on both processes: the tracer (a file
    # each), the audit bus, the telemetry publishers; the SLO monitor on
    # the frontend; JSONL logs on the worker
    wk_trace = os.path.join(work, "trace_worker.jsonl")
    fe_trace = os.path.join(work, "trace_frontend.jsonl")
    audit = os.path.join(work, "audit.jsonl")
    armed = {"DYN_TRACE": "1", "DYN_AUDIT": "1", "DYN_AUDIT_SINKS": "jsonl",
             "DYN_AUDIT_PATH": audit}
    try:
        coord = Service(work, "coordinator", "--port", str(free_port()))
        services.append(coord)
        store = coord.wait_line("COORDINATOR_READY", 120)
        t0 = time.perf_counter()
        worker = Service(work, "worker", "--model", ckpt, "--random-init",
                         "--router-mode", "round_robin", "--num-pages",
                         "2048", "--max-batch-size", "8", "--prefill-chunk",
                         "512", "--store", store, "--device", "cuda",
                         "--system-port", str(sys_port), "--health-check",
                         "--health-check-interval",
                         f"{HEALTH_INTERVAL_S:g}", "--telemetry-interval",
                         f"{TELEMETRY_INTERVAL_S:g}",
                         env={"DYN_WATCHDOG_STALL_S": f"{WATCHDOG_STALL_S:g}",
                              "DYN_SMOKE_API_TOKEN": "chip-smoke-secret",
                              "DYN_TRACE_PATH": wk_trace,
                              "DYN_LOG_FORMAT": "jsonl", **armed})
        services.append(worker)
        port = free_port()
        frontend = Service(work, "frontend", "--store", store, "--host",
                           "127.0.0.1", "--port", str(port),
                           "--router-mode", "round_robin", "--system-port",
                           str(fe_sys), "--stream-idle-adaptive-margin",
                           f"{ADAPTIVE_IDLE_MARGIN:g}", "--telemetry-interval",
                           f"{TELEMETRY_INTERVAL_S:g}", "--slo-ttft",
                           f"{SLO_TTFT_S:g}", "--slo-itl", f"{SLO_ITL_S:g}",
                           "--slo-check-interval",
                           f"{SLO_CHECK_INTERVAL_S:g}",
                           env={"DYN_TRACE_PATH": fe_trace, **armed})
        services.append(frontend)
        frontend.wait_line("FRONTEND_READY", 120)
        ready = worker.wait_line("WORKER_READY", 900)
        # before traffic: the worker is live, its first idle canary runs
        # through the cold engine (one token: its TTFT is its wall), and
        # /health answers healthy
        st, live = _http_status(sys_port, "/live")
        if st != 200 or json.loads(live) != {"status": "live"}:
            raise AssertionError(f"worker /live: {st} {live!r}")
        end, first_canary = time.perf_counter() + 60, None
        while first_canary is None:
            text = _http_status(sys_port, "/metrics")[1].decode()
            n = requests_served(text)
            if n >= 1:
                first_canary = (prometheus_value(
                    text, "dynamo_engine_ttft_seconds_sum") if n == 1
                    else float("nan"))
            elif time.perf_counter() > end:
                raise AssertionError("no canary ran before traffic")
            time.sleep(0.05)
        while True:
            st, health = _http_status(sys_port, "/health")
            if st == 200 or time.perf_counter() > end:
                break
            time.sleep(0.2)
        if st != 200 or json.loads(health)["status"] != "healthy":
            raise AssertionError(f"/health before traffic: {st} {health!r}")
        probe_lines = [m for m in log_messages(worker.stderr_tail(200000))
                       if "canary" in m]
        log(f"[status] before traffic: worker /live 200, /health 200 "
            f"{json.loads(health)} ({ready} under canary watch, interval "
            f"{HEALTH_INTERVAL_S:g} s, probe timeout 3 s); the first canary "
            f"through the cold 8B engine took {first_canary:.3f} s (one "
            f"token: its TTFT; its graph captures inside); canary log "
            f"lines: {probe_lines or 'none'}; on {smi}")
        built = [m for m in log_messages(worker.stderr_tail(100000))
                 if "engine built in" in m]
        log(f"[serve] worker {ready} ready {time.perf_counter() - t0:.1f} s "
            f"after its start; {built[-1] if built else ''}")
        end = time.perf_counter() + 60
        while b'"llama3-8b"' not in _http_get(port, "/v1/models"):
            if time.perf_counter() > end:
                raise AssertionError("the frontend never discovered the "
                                     "worker's card")
            time.sleep(0.2)
        bodies = [{"model": "llama3-8b", "stream": True, "max_tokens": 32,
                   "messages": [{"role": "user", "content": d["text"]}],
                   **{k: v for k, v in d.items() if k != "text"}}
                  for d in lines]
        with ThreadPoolExecutor(len(bodies)) as pool:
            streams = list(pool.map(lambda b: http_chat_stream(port, b),
                                    bodies))
        wall = max(s["t0"] + s["elapsed_s"] for s in streams) - \
            min(s["t0"] for s in streams)
        for p in services:
            if p.proc.poll() is not None:
                raise AssertionError(f"{p.name} exited: "
                                     f"{p.stderr_tail()}")
        traced = request_traces(port, fe_trace, wk_trace, streams, smi)
        audit_records(audit, streams)
        fe_metrics = _http_get(port, "/metrics").decode()
        with torch.inference_mode():
            serving_extras(torch, port, model, llama)
        (wk_metrics,) = asyncio.run(worker_scrape(store)).values()
        # a wave whose every frame carries text (random weights' tokens
        # are mostly not bytes: the frontend's ITL histogram counts text
        # frames), so the frontend holds >= 100 ITL samples
        itl_wave = [{"model": "llama3-8b", "stream": True, "max_tokens": 128,
                     **GREEDY_FIELDS,
                     "messages": [{"role": "user", "content": f"letters {i}"}],
                     "nvext": {"guided_regex": "[a-z]{128}"}}
                    for i in range(ITL_WAVE)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(ITL_WAVE) as pool:
            wave = list(pool.map(lambda b: http_chat_stream(port, b),
                                 itl_wave))
        if any(len(w["tokens"]) != 128 for w in wave):
            raise AssertionError("an ITL-wave stream broke its grammar")
        log(f"[status] a guided wave of {ITL_WAVE} x 128 letters through "
            f"the frontend in {time.perf_counter() - t0:.2f} s")
        # the SLO monitor's samples are the HTTP layer's TTFT / ITL, taken
        # at text-bearing chunks: the wave's letters, not the batch's
        # random tokens (which decode to no text)
        fleet_and_slo(port, sys_port, smi)
        # requests through the engine: the batch, the n = 2 chat's two
        # choices, the /v1/responses request (an embedding has no TTFT)
        # and the wave
        status_surfaces(sys_port, fe_sys, store, smi,
                        len(bodies) + 3 + ITL_WAVE, HEALTH_INTERVAL_S,
                        WATCHDOG_STALL_S, ADAPTIVE_IDLE_MARGIN)
    finally:
        for p in reversed(services):
            p.stop()
    # the worker's stderr under DYN_LOG_FORMAT=jsonl: every line JSON
    with open(worker.err_path) as f:
        err_lines = [ln for ln in f.read().splitlines() if ln.strip()]
    for ln in err_lines:
        try:
            row = json.loads(ln)
        except ValueError:
            raise AssertionError(f"8c: a worker stderr line is not JSON "
                                 f"under DYN_LOG_FORMAT=jsonl: {ln[:300]!r}")
        if not {"ts", "level", "target", "message"} <= set(row):
            raise AssertionError(f"8c: a worker log line lacks its keys: "
                                 f"{ln[:300]!r}")
    spans = read_spans(fe_trace, wk_trace)
    log(f"[trace] after the deployment stopped: {len(err_lines)} worker "
        f"stderr lines, all JSON; {len(spans)} spans exported in all "
        f"(frontend {len(read_spans(fe_trace))}, worker "
        f"{len(read_spans(wk_trace))}), {traced} of them the 10 requests'")
    # tokens against the in-process phase-path batch
    want = [token_ids_of(r["logprobs"]) for r in in_proc["results"]]
    got = [(s["tokens"], s["tops"]) for s in streams]
    partings = compare_streams(want, got, "serve")
    log(f"[serve] {len(streams)} HTTP streams complete (200, SSE, [DONE], "
        f"finish reasons {sorted({s['finish'] for s in streams})}); "
        f"{len(streams) - len(partings)} token-identical with the "
        f"in-process phase-path batch, {len(partings)} parted at near-ties")
    rows_http = [{"ttft_s": s["ttft_s"], "elapsed_s": s["elapsed_s"],
                  "n": len(s["tokens"])} for s in streams]
    rows_proc = [{"ttft_s": r["ttft_s"], "elapsed_s": r["elapsed_s"],
                  "n": r["completion_tokens"]} for r in in_proc["results"]]
    log(f"[serve] through HTTP (coordinator + worker + frontend, 3 "
        f"processes): {latency_summary(rows_http, wall)}; on {smi}")
    log(f"[serve] in process (phase 8's phase-path batch, same requests, "
        f"prefill_chunk_budget 512): "
        f"{latency_summary(rows_proc, in_proc['wall'])}; on {smi}")
    frames = prometheus_value(
        fe_metrics, 'dynamo_transport_client_events{kind="frames"}')
    log(f"[serve] the frontend received {frames:.0f} response frames in "
        f"{wall:.2f} s: {frames / wall:.1f} frames/s "
        f"({sum(r['n'] for r in rows_http) / frames:.2f} tokens per frame)")
    graphs = worker_graphs(wk_metrics)
    if not graphs["replays"] > graphs["captures"] > 0:
        raise AssertionError(f"the worker replayed no CUDA graph: {graphs}")
    log(f"[serve] worker metrics (its _sys.stats scrape): CUDA graph "
        f"captures {graphs['captures']:.0f}, replays "
        f"{graphs['replays']:.0f}, pool {graphs['pool_bytes'] / 2**20:.1f} "
        f"MiB; on {smi}")


def log_messages(text: str) -> list:
    """The messages of log lines, JSONL (DYN_LOG_FORMAT=jsonl) or text."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln)["message"])
                continue
            except (ValueError, KeyError):
                pass
        out.append(ln.split(": ", 1)[-1])
    return out


def read_spans(*paths: str) -> list:
    """The OTLP span records of trace files (a missing file reads as
    none)."""
    from dynamo_tpu_torch.runtime.recorder import Recorder

    rows = []
    for p in paths:
        if os.path.exists(p):
            rows.extend(ev for _, ev in Recorder.iter_events(p))
    return rows


def span_attr(span: dict, key: str):
    for a in span["attributes"]:
        if a["key"] == key:
            return a["value"]["stringValue"]
    return None


def span_ms(span: dict) -> float:
    return (span["endTimeUnixNano"] - span["startTimeUnixNano"]) / 1e6


def request_traces(port: int, fe_trace: str, wk_trace: str, streams: list,
                   smi: str) -> int:
    """Phase 8c: each streamed request is one trace. /debug/requests lists
    them with status 200 and their trace ids; the frontend's file holds
    each one's `http chat_completions` span, the worker's its serve span,
    `engine.request` under it and under that `engine.queue_wait`, >= 1
    `engine.prefill.chunk`, `engine.prefill` and `engine.decode`; every
    parent id resolves. Prints per request (and as medians) the queue
    wait, prefill and decode ms from the spans beside the HTTP TTFT, and
    the share of each TTFT inside chunk dispatches that paid a graph
    capture. Returns the spans the requests hold."""
    n = len(streams)
    st, raw = _http_status(port, f"/debug/requests?limit={n}")
    dbg = json.loads(raw)
    recent = dbg["recent"]
    by_rid = {r["request_id"]: r for r in recent}
    if st != 200 or dbg["in_flight"] or len(recent) != n or any(
            r["status"] != "200" or not r["trace_id"] for r in recent) or \
            set(by_rid) != {s["id"] for s in streams}:
        rows = [(r["request_id"], r["status"], r["trace_id"])
                for r in recent]
        raise AssertionError(f"8c /debug/requests: HTTP {st}, {rows}")
    want = {by_rid[s["id"]]["trace_id"] for s in streams}
    if len(want) != n:
        raise AssertionError("8c: two requests share a trace id")

    def complete(spans) -> bool:
        names = [x["name"] for x in spans]
        return (names.count("http chat_completions") == 1
                and sum(x.startswith("serve ") for x in names) == 1
                and names.count("engine.request") == 1
                and all(stage in names for stage in ENGINE_STAGES))

    end = time.perf_counter() + 30
    while True:
        fe_rows, wk_rows = read_spans(fe_trace), read_spans(wk_trace)
        by: dict = {}
        for r in fe_rows + wk_rows:
            by.setdefault(r["traceId"], []).append(r)
        missing = [t for t in want if not complete(by.get(t, []))]
        if not missing:
            break
        if time.perf_counter() > end:
            names = [sorted(x["name"] for x in by.get(t, []))
                     for t in missing[:2]]
            raise AssertionError(f"8c: {len(missing)} of {n} traces "
                                 f"incomplete: {names}")
        time.sleep(0.5)
    fe_ids = {r["spanId"] for r in fe_rows}
    rows, held = [], 0
    for s in sorted(streams, key=lambda x: x["t0"]):
        tid = by_rid[s["id"]]["trace_id"]
        spans = by[tid]
        held += len(spans)
        ids = {x["spanId"] for x in spans}
        one = {x["name"]: x for x in spans}
        http = one["http chat_completions"]
        serve = next(x for x in spans if x["name"].startswith("serve "))
        root = one["engine.request"]
        if any(x["parentSpanId"] and x["parentSpanId"] not in ids
               for x in spans) or http["parentSpanId"] or \
                http["spanId"] not in fe_ids or \
                serve["parentSpanId"] != http["spanId"] or \
                root["parentSpanId"] != serve["spanId"] or any(
                    x["parentSpanId"] != root["spanId"] for x in spans
                    if x["name"] in ENGINE_STAGES) or \
                root["status"]["code"] != "OK":
            tree = [(x["name"], x["spanId"], x["parentSpanId"])
                    for x in spans]
            raise AssertionError(f"8c: trace {tid} is not one tree: {tree}")
        chunks = [x for x in spans if x["name"] == "engine.prefill.chunk"]
        compiled = sum(span_ms(x) for x in chunks
                       if span_attr(x, "compiled") == "True")
        ttft = s["ttft_s"] * 1e3
        rows.append({"ttft": ttft, "queue": span_ms(one["engine.queue_wait"]),
                     "prefill": span_ms(one["engine.prefill"]),
                     "decode": span_ms(one["engine.decode"]),
                     "chunks": len(chunks), "compiled": compiled,
                     "events": sorted({e["name"] for e in root["events"]})})
    for i, r in enumerate(rows):
        log(f"[trace] request {i} (by send time): HTTP TTFT "
            f"{r['ttft']:.1f} ms; engine.queue_wait {r['queue']:.2f} ms, "
            f"engine.prefill {r['prefill']:.1f} ms ({r['chunks']} chunk "
            f"span(s), {r['compiled']:.1f} ms of them in dispatches that "
            f"captured a graph: {100 * r['compiled'] / r['ttft']:.1f}% of "
            f"the TTFT), engine.decode {r['decode']:.1f} ms; root events "
            f"{r['events']}; on {smi}")

    def med(k):
        return statistics.median(r[k] for r in rows)

    share = [r["compiled"] / r["ttft"] for r in rows]
    log(f"[trace] 10 requests, one trace each (http -> serve -> "
        f"engine.request -> queue_wait / prefill.chunk / prefill / decode, "
        f"every parent resolved, /debug/requests 200 with the trace ids): "
        f"medians queue wait {med('queue'):.2f} ms, prefill "
        f"{med('prefill'):.1f} ms, decode {med('decode'):.1f} ms beside "
        f"HTTP TTFT {med('ttft'):.1f} ms; TTFT share in capturing chunk "
        f"dispatches: median {100 * statistics.median(share):.1f}%, first "
        f"request {100 * share[0]:.1f}%; on {smi}")
    return held


def fleet_and_slo(port: int, sys_port: int, smi: str) -> None:
    """Phase 8c, after the guided wave: /fleet/status holds the worker's
    snapshot, its TTFT p50 within one bucket of a scrape of the worker's
    `dynamo_engine_ttft_seconds`; the SLO monitor reads `ttft` breach and
    `itl` ok and its burn rates render on the frontend's /metrics; the
    tracer dropped nothing in either process."""
    end = time.perf_counter() + 30
    while True:
        st, raw = _http_status(port, "/fleet/status")
        fleet = json.loads(raw)
        wk_text = _http_status(sys_port, "/metrics")[1].decode()
        n_scr, p50_scr = scrape_hist_quantile(
            wk_text, "dynamo_engine_ttft_seconds", 0.5)
        workers = [c for c in fleet.get("components", ())
                   if c["role"] == "worker"]
        lat = workers[0]["latency"].get("ttft", {}) if workers else {}
        slo = fleet.get("slo", {})
        if st == 200 and lat.get("count") == n_scr and \
                slo.get("ttft", {}).get("state") == "breach":
            break
        if time.perf_counter() > end:
            break
        time.sleep(0.5)
    roles = sorted(c["role"] for c in fleet.get("components", ()))
    if st != 200 or roles != ["frontend", "worker"] or not lat:
        raise AssertionError(f"8c /fleet/status: HTTP {st}, components "
                             f"{roles}, worker latency {lat}")
    edges = [float(ln.split('"')[1]) for ln in wk_text.splitlines()
             if ln.startswith("dynamo_engine_ttft_seconds_bucket{le=")
             and "+Inf" not in ln]
    pos = [min(range(len(edges)), key=lambda i: abs(edges[i] - v))
           for v in (lat["p50"], p50_scr)]
    if abs(pos[0] - pos[1]) > 1 or lat["source"] != \
            "dynamo_engine_ttft_seconds":
        raise AssertionError(f"8c: fleet TTFT p50 {lat} vs the worker's "
                             f"scrape ({n_scr} samples, p50 {p50_scr})")
    if slo.get("ttft", {}).get("state") != "breach" or \
            slo.get("itl", {}).get("state") != "ok":
        raise AssertionError(f"8c SLO states: {slo}")
    fe_text = _http_get(port, "/metrics").decode()
    burn = series_values(fe_text, "dynamo_slo_burn_rate")
    dropped = (prometheus_value(fe_text, "dynamo_trace_dropped_total"),
               prometheus_value(wk_text, "dynamo_trace_dropped_total"))
    exported = (prometheus_value(fe_text, "dynamo_trace_exported_total"),
                prometheus_value(wk_text, "dynamo_trace_exported_total"))
    if len(burn) != 4 or dropped != (0.0, 0.0):
        raise AssertionError(f"8c: burn-rate gauges {burn}, trace drops "
                             f"(frontend, worker) {dropped}")
    log(f"[fleet] /fleet/status: components {roles}, the worker's TTFT "
        f"p50 {lat['p50'] * 1e3:.0f} ms over {lat['count']} samples (its "
        f"scrape: {p50_scr * 1e3:.0f} ms over {n_scr}; bucket upper "
        f"edges), fleet-merged TTFT p50 "
        f"{fleet['fleet']['latency']['ttft']['p50'] * 1e3:.0f} ms; SLO ttft "
        f"{slo['ttft']['state']} (fast burn {slo['ttft']['fast_burn']}, "
        f"{slo['ttft']['samples']} samples, objective {SLO_TTFT_S:g} s), "
        f"itl {slo['itl']['state']} (fast burn {slo['itl']['fast_burn']}, "
        f"{slo['itl']['samples']} samples, objective {SLO_ITL_S:g} s); "
        f"dynamo_slo_burn_rate {burn}; spans exported (frontend, worker) "
        f"{exported}, dropped {dropped}; on {smi}")


def audit_records(path: str, streams: list) -> None:
    """Phase 8c: the frontend's audit file (DYN_AUDIT_SINKS=jsonl) has one
    record per streamed request, its text the stream's and its usage the
    final chunk's."""
    from dynamo_tpu_torch.runtime.recorder import Recorder

    end = time.perf_counter() + 30
    while True:
        recs = [ev for _, ev in Recorder.iter_events(path)] \
            if os.path.exists(path) else []
        if len(recs) >= len(streams) or time.perf_counter() > end:
            break
        time.sleep(0.5)
    by = {r["request_id"]: r for r in recs}
    if len(recs) != len(streams) or set(by) != {s["id"] for s in streams}:
        raise AssertionError(f"8c audit: {len(recs)} records for "
                             f"{len(streams)} streams")
    for s in streams:
        r = by[s["id"]]
        if r["response_text"] != s["text"] or r["usage"] != s["usage"] or \
                r["endpoint"] != "chat_completions" or r["error"]:
            raise AssertionError(f"8c audit record {s['id']}: text "
                                 f"{r['response_text']!r} vs {s['text']!r}, "
                                 f"usage {r['usage']} vs {s['usage']}")
    log(f"[audit] {len(recs)} records, one per stream, each with the "
        f"stream's text ({sum(len(s['text']) for s in streams)} characters "
        f"in all: random weights emit few byte tokens) and its usage "
        f"({sum(s['usage']['completion_tokens'] for s in streams)} "
        f"completion tokens in all)")


def _http_status(port: int, path: str) -> tuple[int, bytes]:
    """One GET: (status, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _http_raw(port: int, path: str, body: dict) -> tuple[int, str, bytes]:
    """One POST: (status, content type, raw body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type") or "", r.read()
    finally:
        conn.close()


def scrape_hist_quantile(text: str, name: str, q: float) -> tuple:
    """(count, q-quantile) of a histogram in a Prometheus scrape, by the
    runtime's own `hist_quantile` (what the adaptive idle timeout reads
    in the process that owns the histogram)."""
    from dynamo_tpu_torch.runtime.metrics import hist_quantile

    edges, cum = [], []
    for line in text.splitlines():
        if line.startswith(name + "_bucket{le="):
            le = line.split('"')[1]
            edges.append(float("inf") if le == "+Inf" else float(le))
            cum.append(float(line.split()[-1]))
    counts = [c - p for c, p in zip(cum, [0.0] + cum[:-1])]
    return int(cum[-1]) if cum else 0, hist_quantile(edges[:-1], counts, q)


def status_surfaces(sys_port: int, fe_sys: int, store: str, smi: str,
                    requests_sent: int, interval: float, stall_s: float,
                    margin: float) -> None:
    """Phase 8c's status checks after traffic: idle for more than three
    canary intervals; the worker's canaries ran through its engine
    (`dynamo_engine_ttft_seconds_count` beyond the requests sent), its
    /health is still 200, its /metrics carries the CUDA-graph series its
    `_sys.stats` scrape carries, /config names torch and redacts the
    secret the script set, its watchdog never tripped (the longest stall
    with work pending printed beside the threshold); the frontend's
    system port is live, it saw no idle timeout, and the adaptive idle
    timeout it derives once 100 ITL samples exist is printed."""
    st, before = _http_status(sys_port, "/metrics")
    n0 = requests_served(before.decode())
    time.sleep(3.5 * interval)
    st, m = _http_status(sys_port, "/metrics")
    (sc,) = asyncio.run(worker_scrape(store)).values()
    text = m.decode()
    served = requests_served(text)
    canaries = served - requests_sent
    if st != 200 or served - n0 < 2 or canaries < 2:
        raise AssertionError(f"idle canaries did not run through the 8B "
                             f"engine: {served} served, {requests_sent} "
                             f"requests sent, {served - n0} while idle")
    st, health = _http_status(sys_port, "/health")
    if st != 200 or json.loads(health) != {"status": "healthy",
                                           "failing": []}:
        raise AssertionError(f"/health after traffic: {st} {health!r}")
    http_g, sc_g = worker_graphs(text), worker_graphs(sc)
    if not (http_g["captures"] == sc_g["captures"] > 0
            and http_g["pool_bytes"] == sc_g["pool_bytes"]
            and sc_g["replays"] >= http_g["replays"] > 0):
        raise AssertionError(f"/metrics {http_g} vs _sys.stats {sc_g}")
    st, cfg = _http_status(sys_port, "/config")
    cfg = json.loads(cfg)
    if st != 200 or cfg["env"].get("DYN_SMOKE_API_TOKEN") != "[redacted]" \
            or cfg["versions"].get("torch") in (None, "unknown") \
            or not cfg["versions"].get("cuda"):
        raise AssertionError(f"/config: {st} {cfg.get('env')} "
                             f"{cfg.get('versions')}")
    trips = series_values(text, "dynamo_watchdog_trips_total")
    longest = prometheus_value(text, "dynamo_watchdog_longest_stall_seconds")
    if any(v > 0 for v in trips.values()):
        raise AssertionError(f"the dispatch watchdog tripped: {trips}")
    st, fe_live = _http_status(fe_sys, "/live")
    st_m, fe_m = _http_status(fe_sys, "/metrics")
    fe_text = fe_m.decode()
    idle = prometheus_value(
        fe_text, 'dynamo_transport_client_events{kind="idle_timeouts"}')
    n_itl, p999 = scrape_hist_quantile(
        fe_text, "dynamo_http_inter_token_latency_seconds", 0.999)
    if st != 200 or st_m != 200 or idle != 0:
        raise AssertionError(f"frontend system port: /live {st}, "
                             f"/metrics {st_m}, idle timeouts {idle}")
    derived = (p999 * margin if n_itl >= 100 and p999 != float("inf")
               else 0.0)
    n_eng, p_eng = scrape_hist_quantile(text, "dynamo_engine_itl_ms", 0.999)
    log(f"[status] worker: {served} requests through its engine, "
        f"{requests_sent} sent: {canaries} idle canaries (health interval "
        f"{interval:g} s, {served - n0} in the last {3.5 * interval:g} s "
        f"idle); /health 200 healthy; /metrics and _sys.stats carry the "
        f"same CUDA-graph series (captures {http_g['captures']:.0f}, pool "
        f"{http_g['pool_bytes'] / 2**20:.1f} MiB, replays "
        f"{http_g['replays']:.0f} / {sc_g['replays']:.0f}); /config names "
        f"torch {cfg['versions']['torch']} (CUDA "
        f"{cfg['versions']['cuda']}) and redacts DYN_SMOKE_API_TOKEN; on "
        f"{smi}")
    log(f"[status] watchdog: 0 trips; longest stretch with work pending "
        f"and no forward progress {longest:.3f} s beside "
        f"DYN_WATCHDOG_STALL_S {stall_s:g} s; on {smi}")
    why = ("" if derived else
           " (below 100 samples: the static timeout)" if n_itl < 100 else
           " (p99.9 above the histogram's top bucket: the runtime keeps the "
           "static timeout, as the reference's)")
    log(f"[status] frontend: 0 idle timeouts; {n_itl} HTTP ITL samples, "
        f"p99.9 {p999:g} s x margin {margin:g} = adaptive idle timeout "
        f"{derived:g} s{why}; the worker's engine ITL histogram ({n_eng} "
        f"samples, p99.9 {p_eng:g} ms) would give "
        f"{p_eng * 1e-3 * margin if p_eng != float('inf') else 0.0:g} s; "
        f"on {smi}")


# in-process parser run: the guided regexes that make random weights
# write a hermes tool call and a think block
HERMES_CALL_RE = (r'<tool_call>\n\{"name": "get_weather", "arguments": '
                  r'\{"city": "[A-Z][a-z]{2,8}"\}\}\n</tool_call>')
THINK_RE = r"<think>[a-z ]{4,40}</think>[a-z ]{4,40}"
PARSER_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather of a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}}}}}]


class ForceRegex:
    """An engine with a guided regex set on every request: the Responses
    API carries no nvext, so this is how random weights write a think
    block on /v1/responses."""

    def __init__(self, inner, regex: str) -> None:
        self.inner = inner
        self.regex = regex

    async def generate(self, request, context):
        sampling = {**(request.get("sampling") or {}),
                    "guided": {"regex": self.regex}}
        async for out in self.inner.generate({**request,
                                              "sampling": sampling},
                                             context):
            yield out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def sse_chunks(raw: bytes) -> list:
    """The JSON payloads of an SSE body, [DONE] dropped."""
    out = []
    for ev in raw.decode().split("\n\n"):
        for line in ev.split("\n"):
            if line.startswith("data: ") and line != "data: [DONE]":
                out.append(json.loads(line[6:]))
    return out


def parser_phase(torch, smi: str, model, cuda_build, n_pages: int) -> dict:
    """In process on phase 8's weights: a phase-path engine served through
    `serve_engine` and `start_frontend` on a memory store under three
    cards on the same weights: "llama3-8b-tools" (tool_call_parser
    hermes, reasoning_parser basic), "llama3-8b-raw" (no parsers, the
    same endpoint) and "llama3-8b-think" (the parsers, with THINK_RE set
    on every request, for /v1/responses). Launch counts zeroed just
    before the requests and read just after. The prefix cache is cleared
    before each request, so equal prompts give equal streams. Checks:
    the streamed and the unary tool chat each end in "tool_calls" with
    exactly one get_weather call whose arguments are the JSON the raw
    run wrote, and the streamed deltas assemble into the unary message
    (ids aside); the think chat's reasoning_content and content are the
    raw run's think text and what follows it; each of n = 2 choices is
    split on its own; /v1/responses' output_text carries no think text.
    Each request's wall printed."""
    import re

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.entrypoint import serve_engine, start_frontend
    from dynamo_tpu_torch.llm.guided import token_bytes_of
    from dynamo_tpu_torch.llm.model_card import (
        ModelDeploymentCard,
        register_llm,
    )
    from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    cfg = model.cfg
    tok = make_tokenizer("byte")
    eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=n_pages, max_batch_size=8,
        prefill_chunk_budget=512, device="cuda"), model=model,
        token_bytes=lambda: token_bytes_of(tok, cfg.vocab_size),
        eos_token_id=tok.eos_token_id)

    def card(name, component="backend", parsers=True):
        return ModelDeploymentCard(
            name=name, component=component, tokenizer_kind="byte",
            context_length=cfg.context_length, kv_block_size=cfg.page_size,
            router_mode="round_robin",
            tool_call_parser="hermes" if parsers else "",
            reasoning_parser="basic" if parsers else "")

    def chat(model_name, regex, **kw):
        return ("/v1/chat/completions", {
            "model": model_name, "max_tokens": 120, "temperature": 0,
            "messages": [{"role": "user", "content": "weather in a city?"}],
            "nvext": {"guided_regex": regex}, **kw})

    reqs = {
        "raw tool text": chat("llama3-8b-raw", HERMES_CALL_RE),
        "tool chat, streamed": chat("llama3-8b-tools", HERMES_CALL_RE,
                                    tools=PARSER_TOOLS, stream=True),
        "tool chat, unary": chat("llama3-8b-tools", HERMES_CALL_RE,
                                 tools=PARSER_TOOLS),
        "raw think text": chat("llama3-8b-raw", THINK_RE),
        "think chat": chat("llama3-8b-tools", THINK_RE),
        "think chat, n = 2": chat("llama3-8b-tools", THINK_RE, n=2),
        "think /v1/responses": ("/v1/responses", {
            "model": "llama3-8b-think", "input": "weather in a city?",
            "max_output_tokens": 120, "temperature": 0}),
    }

    async def main():
        rt = await DistributedRuntime.create(RuntimeConfig())
        handles, fe = [], None
        try:
            handles.append(await serve_engine(rt, eng,
                                              card("llama3-8b-tools")))
            await register_llm(rt, card("llama3-8b-raw", parsers=False))
            handles.append(await serve_engine(
                rt, ForceRegex(eng, THINK_RE),
                card("llama3-8b-think", "think")))
            fe = await start_frontend(rt, host="127.0.0.1", port=0)
            for name in ("llama3-8b-tools", "llama3-8b-raw",
                         "llama3-8b-think"):
                while fe.manager.get(name) is None:
                    await asyncio.sleep(0.05)
            out = {}
            cuda_build.reset_launch_counts()
            for label, (path, body) in reqs.items():
                for _ in range(500):
                    if eng.pool.active_pages == 0:
                        break
                    await asyncio.sleep(0.01)
                eng.clear_kv_blocks()
                t0 = time.perf_counter()
                out[label] = await asyncio.to_thread(
                    _http_raw, fe.http.port, path, body)
                out[label] += (time.perf_counter() - t0,)
            torch.cuda.synchronize()
            return out, cuda_build.launch_counts(), graph_stats(eng)
        finally:
            if fe is not None:
                await fe.stop()
            for h in handles:
                await h.stop()
            await eng.close()
            await rt.close()

    out, launches, stats = asyncio.run(main())
    for label, (st, ctype, raw, wall) in out.items():
        if st != 200:
            raise AssertionError(f"{label}: HTTP {st}: {raw[:500]!r}")
    body = {k: json.loads(v[2]) for k, v in out.items()
            if not v[1].startswith("text/event-stream")}
    # the hermes call
    raw_call = body["raw tool text"]["choices"][0]["message"]["content"]
    if not re.fullmatch(HERMES_CALL_RE, raw_call):
        raise AssertionError(f"the raw run broke its grammar: {raw_call!r}")
    forced = json.loads(raw_call.split("\n")[1])["arguments"]
    unary = body["tool chat, unary"]["choices"][0]
    calls = unary["message"].get("tool_calls") or []
    if unary["finish_reason"] != "tool_calls" or len(calls) != 1 \
            or calls[0]["function"]["name"] != "get_weather" \
            or json.loads(calls[0]["function"]["arguments"]) != forced:
        raise AssertionError(f"unary tool chat: {unary}")
    chunks = sse_chunks(out["tool chat, streamed"][2])
    s_calls = [tc for c in chunks for ch in c["choices"]
               for tc in ch["delta"].get("tool_calls") or ()]
    s_text = "".join(ch["delta"].get("content") or "" for c in chunks
                     for ch in c["choices"])
    finish = [ch["finish_reason"] for c in chunks for ch in c["choices"]
              if ch.get("finish_reason")]

    def no_ids(tc):
        return {k: v for k, v in tc.items() if k not in ("id", "index")}

    if finish != ["tool_calls"] or [no_ids(t) for t in s_calls] != \
            [no_ids(t) for t in calls] \
            or s_text != (unary["message"].get("content") or ""):
        raise AssertionError(f"streamed tool chat {s_calls} {finish} "
                             f"{s_text!r} vs unary {unary}")
    # the think split
    raw_think = body["raw think text"]["choices"][0]["message"]["content"]
    m = re.fullmatch(r"<think>([a-z ]{4,40})</think>([a-z ]{4,40})",
                     raw_think)
    if m is None:
        raise AssertionError(f"the raw run broke its grammar: {raw_think!r}")
    think, after = m.groups()
    msg = body["think chat"]["choices"][0]["message"]
    if msg.get("reasoning_content") != think or msg.get("content") != after:
        raise AssertionError(f"think chat {msg} vs raw {raw_think!r}")
    n2 = body["think chat, n = 2"]["choices"]
    for c in n2:
        r_, t_ = (c["message"].get("reasoning_content") or "",
                  c["message"].get("content") or "")
        if "<think>" in t_ or "</think>" in t_ or not re.fullmatch(
                THINK_RE, f"<think>{r_}</think>{t_}"):
            raise AssertionError(f"n = 2 choice {c['index']}: {c}")
    if sorted(c["index"] for c in n2) != [0, 1]:
        raise AssertionError(f"n = 2: {n2}")
    text = body["think /v1/responses"].get("output_text", "")
    if think in text or "think>" in text \
            or body["think /v1/responses"].get("status") != "completed":
        raise AssertionError(f"/v1/responses output_text {text!r} carries "
                             f"the think text {think!r}")
    for kname in ("paged_kv_write", "paged_kv_write_pages",
                  "paged_attention_decode", "ragged_paged_attention"):
        if launches[kname] == 0:
            raise AssertionError(f"kernel {kname} never launched on the "
                                 f"parser run")
    log(f"[parsers] hermes tool call on the 8B engine (guided regex): "
        f"get_weather({json.dumps(forced)}), streamed = unary (ids aside); "
        f"think split: reasoning {think!r}, content {after!r}; n = 2: each "
        f"choice split on its own; /v1/responses output_text {text!r} "
        f"(== the chat's content: {text == after}); launches {launches}; "
        f"graphs: {stats['captures']} captures, {stats['replays']} replays")
    log("[parsers] walls: " + "; ".join(
        f"{label} {v[3]:.3f} s" for label, v in out.items()) + f"; on {smi}")
    return {"launches": launches, "walls": {k: v[3] for k, v in out.items()}}


def worker_graphs(text: str) -> dict:
    """A worker scrape's CUDA-graph captures, replays and pool bytes."""
    return {kind: prometheus_value(
        text, 'dynamo_engine_cuda_graphs{kind="%s"}' % kind)
        for kind in ("captures", "replays", "pool_bytes")}


def requests_served(text: str) -> int:
    """Requests a worker has answered: its TTFT histogram's count."""
    return int(prometheus_value(text, "dynamo_engine_ttft_seconds_count"))


def series_values(text: str, name: str) -> dict:
    """{labels: value} of one Prometheus series in a scrape."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line.rsplit(" ", 1)
            out[key[len(name):]] = float(value)
    return out


# phase 8d: the prefixes' and suffixes' bytes (a chat prompt is
# "user: " + text + "\nassistant:" under the byte tokenizer, so a 1024-
# byte prefix fills the first 64 pages of 16 of every prompt that starts
# with it)
KV_PREFIX_BYTES = 1024
KV_PAGE = 16
KV_SUFFIXES = 8


def kv_router_phase(torch, smi: str, work: str, ckpt: str, model, card,
                    n_pages: int) -> None:
    """Phase 8d: two 8B workers behind the port's KV router (see the
    module docstring). Raises on any failed check."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.run.main import build_pipeline_for, run_batch
    from dynamo_tpu_torch.runtime.distributed import free_port

    cfg = model.cfg
    rng = random.Random(8)
    alphabet = "abcdefghij klmnop qrstuv wxyz.,"
    prefixes = ["".join(rng.choice(alphabet) for _ in range(KV_PREFIX_BYTES))
                for _ in range(2)]
    wave2 = [(i % 2, prefixes[i % 2] + "".join(
        rng.choice(alphabet) for _ in range(rng.randrange(32, 201))))
        for i in range(KV_SUFFIXES)]
    # the reference streams: each wave-2 request alone and cold (the
    # prefix cache cleared before each) on an in-process engine with the
    # workers' scheduling (prefill chunk 512, no chunk budget)
    cold_eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=256, max_batch_size=8, prefill_chunk=512,
        device="cuda"), model=model)
    pipeline = build_pipeline_for(card, cold_eng, type(
        "Args", (), {"tokenizer": "auto", "context_length": None,
                     "max_tokens": 32})())

    async def cold_runs():
        out = []
        try:
            for i, (_, text) in enumerate(wave2):
                path = os.path.join(work, f"kv_cold_{i}.jsonl")
                with open(path, "w") as f:
                    f.write(json.dumps({"text": text, **GREEDY_FIELDS}) + "\n")
                (r,) = await run_batch(pipeline, card.name, path, 32,
                                       os.path.join(work, "kv_cold.out"))
                while cold_eng.pool.active_pages:
                    await asyncio.sleep(0.001)
                cold_eng.clear_kv_blocks()
                out.append(token_ids_of(r["logprobs"]))
        finally:
            await cold_eng.close()
        return out

    t0 = time.perf_counter()
    cold = asyncio.run(cold_runs())
    del cold_eng, pipeline
    torch.cuda.empty_cache()
    log(f"[kv] {len(cold)} wave-2 requests served alone and cold in "
        f"process in {time.perf_counter() - t0:.1f} s (the reference "
        f"streams)")

    # memory: each worker holds bf16 weights, its KV pool and its graph
    # pool and CUDA context; fewer pages only if two do not fit
    free, total = torch.cuda.mem_get_info()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    page_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.page_size
                  * cfg.head_dim * 2)
    overhead = 2 * 2**30
    pages = n_pages
    fit = int((free / 2 - weights - overhead) // page_bytes)
    if fit < pages:
        pages = fit
        log(f"[kv] the card runs short for two workers of {n_pages} pages: "
            f"each worker's pool cut to {pages} pages")
    log(f"[kv] before the workers start: {free / 2**30:.1f} GiB free of "
        f"{total / 2**30:.1f} GiB (this process holds phase 8's model); "
        f"each worker: {weights / 1e9:.2f} GB bf16 weights + "
        f"{pages * page_bytes / 1e9:.2f} GB KV pool ({pages} pages)")
    services = []
    try:
        coord = Service(work, "coordinator", "--port", str(free_port()))
        services.append(coord)
        store = coord.wait_line("COORDINATOR_READY", 120)
        t0 = time.perf_counter()
        workers = []
        for wid in (1, 2):
            w = Service(work, "worker", "--model", ckpt, "--random-init",
                        "--router-mode", "kv", "--num-pages", str(pages),
                        "--max-batch-size", "8", "--prefill-chunk", "512",
                        "--store", store, "--device", "cuda",
                        "--instance-id", str(wid))
            w.name = f"worker{wid}"
            workers.append(w)
            services.append(w)
        port = free_port()
        # the tracer and the decision log armed: each decision's
        # router.decide span against the log's record of it
        kv_trace = os.path.join(work, "trace_kv_frontend.jsonl")
        # the router's recorders too: its KV-event capture and the
        # prefix-heat plane (which moves no placement)
        capture = os.path.join(work, "kv_capture_8b.jsonl")
        frontend = Service(work, "frontend", "--store", store, "--host",
                           "127.0.0.1", "--port", str(port),
                           "--router-mode", "kv", "--telemetry-interval",
                           "1",
                           env={"DYN_TRACE": "1", "DYN_TRACE_PATH": kv_trace,
                                "DYN_ROUTER_LOG": "1",
                                "DYN_KV_RECORD": capture,
                                "DYN_PREFIX_HEAT": "1"})
        services.append(frontend)
        frontend.wait_line("FRONTEND_READY", 120)
        for w in workers:
            ready = w.wait_line("WORKER_READY", 900)
            log(f"[kv] {w.name} {ready} ready "
                f"{time.perf_counter() - t0:.1f} s after the start")
        end = time.perf_counter() + 60
        while b'"llama3-8b"' not in _http_get(port, "/v1/models"):
            if time.perf_counter() > end:
                raise AssertionError("the frontend never discovered the "
                                     "workers' card")
            time.sleep(0.2)
        time.sleep(1.0)       # the router's watch sees both instances
        free_now, _ = torch.cuda.mem_get_info()
        log(f"[kv] with both workers up: {free_now / 2**30:.1f} GiB free on "
            f"the card ({(free - free_now) / 2**30:.1f} GiB taken by the "
            f"two workers and the frontend)")

        def body(text, max_tokens):
            return {"model": "llama3-8b", "stream": True,
                    "max_tokens": max_tokens,
                    "messages": [{"role": "user", "content": text}],
                    **GREEDY_FIELDS}

        def scrape():
            return asyncio.run(worker_scrape(store))

        def served_by() -> dict:
            return {wid: requests_served(t) for wid, t in scrape().items()}

        # wave 1: both prefixes at once
        with ThreadPoolExecutor(2) as pool:
            w1 = list(pool.map(lambda t: http_chat_stream(port, body(t, 8)),
                               prefixes))
        after1 = served_by()
        if sorted(after1.values()) != [1, 1]:
            raise AssertionError(f"wave 1's two prefixes did not land on "
                                 f"different workers: {after1}")
        end = time.perf_counter() + 60
        while True:
            fe = _http_get(port, "/metrics").decode()
            blocks = series_values(fe, "dynamo_router_index_blocks")
            if len(blocks) == 2 and min(blocks.values()) >= 64:
                break
            if time.perf_counter() > end:
                raise AssertionError(f"the router's index never held 64 "
                                     f"blocks per worker: {blocks}")
            time.sleep(0.1)
        log(f"[kv] wave 1: two 1024-byte prefixes at once -> one per "
            f"worker {after1}; router index blocks {blocks}")
        log(f"[kv] frontend index: {radix_log_line(frontend)} (library "
            f"built in {RADIX_BUILD['seconds']:.2f} s in phase 2)")
        # wave 2: one after another, so the overlap decides each
        saved0 = prometheus_value(fe, "dynamo_router_prefill_tokens_saved_total")
        w2 = [http_chat_stream(port, body(text, 32)) for _, text in wave2]
        after2 = served_by()
        fe = _http_get(port, "/metrics").decode()
        saved = prometheus_value(
            fe, "dynamo_router_prefill_tokens_saved_total") - saved0
        per = {wid: after2[wid] - after1[wid] for wid in after2}
        need = KV_SUFFIXES * (KV_PREFIX_BYTES // KV_PAGE) * KV_PAGE
        if sorted(per.values()) != [4, 4] or saved < need:
            raise AssertionError(f"wave 2 did not follow the prefixes: "
                                 f"requests per worker {per}, prefill "
                                 f"tokens saved {saved} (want >= {need})")
        log(f"[kv] wave 2: 8 requests one after another -> {per} per "
            f"worker; prefill tokens saved {saved:.0f} (>= {need}: every "
            f"request on its prefix's worker)")
        # wave 3: the same eight, all in flight
        with ThreadPoolExecutor(len(wave2)) as pool:
            w3 = list(pool.map(lambda t: http_chat_stream(port, body(t, 32)),
                               [text for _, text in wave2]))
        wall3 = max(s["t0"] + s["elapsed_s"] for s in w3) - \
            min(s["t0"] for s in w3)
        after3 = served_by()
        metrics = scrape()
        fe = _http_get(port, "/metrics").decode()
        for p in services:
            if p.proc.poll() is not None:
                raise AssertionError(f"{p.name} exited: {p.stderr_tail()}")
        decide_spans(port, kv_trace, 2 + 2 * len(wave2), smi)
        router_recorders(port, card, prefixes, [t for _, t in wave2])
    finally:
        for p in reversed(services):
            p.stop()
    # every wave-2 stream against its cold in-process stream
    partings = []
    for r, ((ta, ka), s) in enumerate(zip(cold, w2)):
        tb, kb = s["tokens"], s["tops"]
        n = min(len(ta), len(tb))
        if ta[:n] == tb[:n]:
            if len(ta) != len(tb):
                raise AssertionError(f"wave-2 request {r}: {len(tb)} tokens "
                                     f"through the router, {len(ta)} cold")
            continue
        for _, step, gap in stream_partings([(ta[:n], ka[:n])],
                                            [(tb[:n], kb[:n])],
                                            BF16_TIE_TOL):
            partings.append((r, step, gap))
            log(f"[kv] wave-2 request {r} (prefix hit) parts from its cold "
                f"stream at step {step} of {n}: tokens {ta[step]} vs "
                f"{tb[step]}, logprob gap {gap:.4f} nats (tie tolerance "
                f"{BF16_TIE_TOL}); identical before it")
    log(f"[kv] wave 2 against the cold in-process streams: "
        f"{len(w2) - len(partings)} token-identical, {len(partings)} parted "
        f"at near-ties (K3/K4 reading pages another request wrote)")
    for wid, text in metrics.items():
        g = worker_graphs(text)
        if not g["replays"] > g["captures"] > 0:
            raise AssertionError(f"worker {wid} replayed no CUDA graph: {g}")
        log(f"[kv] worker {wid}: CUDA graph captures {g['captures']:.0f}, "
            f"replays {g['replays']:.0f}, pool "
            f"{g['pool_bytes'] / 2**20:.1f} MiB")
    gaps = series_values(fe, "dynamo_router_kv_event_gaps_total")
    if any(gaps.values()):
        raise AssertionError(f"the router counted KV-event gaps: {gaps}")
    events = series_values(fe, "dynamo_router_events_total")
    dropped = series_values(fe, "dynamo_router_events_dropped_total")
    if any(dropped.values()):
        raise AssertionError(f"the router dropped events: {dropped}")
    n_req = 2 + 2 * len(wave2)
    kv_events = events.get('{stream="kv"}', 0.0)
    log(f"[kv] router events by stream {events} ({kv_events / n_req:.1f} KV "
        f"events per request over {n_req} requests); KV-event gaps "
        f"{gaps}; dropped {dropped}")
    ttft1 = [s["ttft_s"] * 1e3 for s in w1]
    ttft2 = [s["ttft_s"] * 1e3 for s in w2]
    log(f"[kv] TTFT, wave 1 (cold 1041-token prompts, two at once): "
        f"{', '.join(f'{t:.1f}' for t in ttft1)} ms; wave 2 (prefix hits, "
        f"one at a time): p50 {statistics.median(ttft2):.1f} ms, max "
        f"{max(ttft2):.1f} ms; on {smi}")
    rows3 = [{"ttft_s": s["ttft_s"], "elapsed_s": s["elapsed_s"],
              "n": len(s["tokens"])} for s in w3]
    per3 = {wid: after3[wid] - after2[wid] for wid in after3}
    log(f"[kv] wave 3 (the 8 again, all in flight): "
        f"{latency_summary(rows3, wall3)}; decisions per worker {per3}; "
        f"on {smi}")


def router_recorders(port: int, card, prefixes: list, wave2: list) -> None:
    """Phase 8d after wave 3: the capture replayed against the live
    router, /debug/prefixes, the fleet's prefix block and the mocker's
    stored chain (see the module docstring)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import make_tokenizer

    pre = OpenAIPreprocessor(
        make_tokenizer(card.tokenizer_kind, card.tokenizer_path), card.name)
    wave1 = [chat_ids(pre, t) for t in prefixes]
    prompts = wave1 + [chat_ids(pre, t) for t in wave2] * 2
    dbg = settle_router(port)
    nat, _ = replay_check("kv", dbg, prompts, KV_PAGE, len(prompts))
    n = mock_chain_check(capture_rows(dbg["kv_record"]["path"]), wave1,
                         KV_PAGE)
    log(f"[kv] a MockEngine of block size {KV_PAGE} given wave 1's prompts "
        f"stores the seq-hash chain of the real workers' captured stored "
        f"events, {n} full blocks, hashes and parents alike")
    prefix_duplication(port, nat, KV_PAGE, KV_BLOCK_NBYTES_8B, len(prompts),
                       "kv")
    fleet_prefix_block(port, "kv")


def decide_spans(port: int, path: str, n: int, smi: str) -> None:
    """Phase 8d: every request routed through the kv frontend has one
    `router.decide` span (under its http span) whose `router.worker` is
    the worker the decision log (/debug/router) records for it."""
    st, raw = _http_status(port, f"/debug/router?limit={4 * n}")
    records = json.loads(raw)["models"][0]["records"] if st == 200 else []
    end = time.perf_counter() + 30
    while True:
        rows = read_spans(path)
        decide = [r for r in rows if r["name"] == "router.decide"]
        http = {r["spanId"] for r in rows if r["name"].startswith("http ")}
        if (len(decide) >= n and len(http) >= n) or \
                time.perf_counter() > end:
            break
        time.sleep(0.5)
    logged = {r["request_id"]: r for r in records}
    bad = [(span_attr(d, "request.id"), span_attr(d, "router.worker"),
            logged.get(span_attr(d, "request.id"), {}).get("worker"))
           for d in decide
           if span_attr(d, "router.worker") != logged.get(
               span_attr(d, "request.id"), {}).get("worker")
           or d["parentSpanId"] not in http]
    if len(decide) != n or len(records) != n or bad:
        raise AssertionError(f"8d: {len(decide)} router.decide spans, "
                             f"{len(records)} logged decisions for {n} "
                             f"requests; mismatched {bad[:3]}")
    by_worker: dict = {}
    for d in decide:
        w = span_attr(d, "router.worker")
        by_worker[w] = by_worker.get(w, 0) + 1
    overlap = sorted(int(span_attr(d, "router.overlap_blocks"))
                     for d in decide)
    log(f"[kv] {n} router.decide spans, each under its request's http span "
        f"and naming the worker the decision log records for it: by worker "
        f"{by_worker}; overlap blocks {overlap}; on {smi}")


# phase 8e: prompts longer than this many uncached tokens are prefilled by
# the prefill worker
DISAGG_MAX_LOCAL = 256


def pull_records(text: str) -> list:
    """The decode worker's per-pull log lines (`disagg/handlers.py`
    `_record_pull`): [{"tid", "path", "tokens", "bytes", "seconds"}]."""
    import re

    rx = re.compile(r"kv pull (\S+): path (\S+), (\d+) tokens, (\d+) bytes "
                    r"in ([0-9.]+) s")
    return [{"tid": m[1], "path": m[2], "tokens": int(m[3]),
             "bytes": int(m[4]), "seconds": float(m[5])}
            for m in rx.finditer(text)]


def import_records(text: str) -> list:
    """The decode worker's per-import log lines (the engine's
    `_observe_import`): [{"tokens", "bytes", "seconds", "clock"}]."""
    import re

    rx = re.compile(r"kv import: (\d+) tokens, (\d+) bytes written in "
                    r"([0-9.]+) s \((\w+) time\)")
    return [{"tokens": int(m[1]), "bytes": int(m[2]),
             "seconds": float(m[3]), "clock": m[4]}
            for m in rx.finditer(text)]


def queue_depth_sampler(store_url: str, queue: str):
    """(start, stop) of a thread that polls the prefill queue's depth
    (unacked items under `v1/queue/dynamo/<queue>/items/`) on the
    coordinator every 5 ms; stop() returns the largest depth seen."""
    import threading

    from dynamo_tpu_torch.runtime.store import connect_store

    seen, done = [0], threading.Event()

    async def poll():
        store = await connect_store(store_url)
        try:
            while not done.is_set():
                items = await store.get_prefix(
                    f"v1/queue/dynamo/{queue}/items/")
                seen[0] = max(seen[0], len(items))
                await asyncio.sleep(0.005)
        finally:
            await store.close()

    thread = threading.Thread(target=lambda: asyncio.run(poll()),
                              daemon=True)

    def stop() -> int:
        done.set()
        thread.join(30)
        return seen[0]

    return thread.start, stop


def disagg_phase(torch, smi: str, work: str, ckpt: str, jobs: str,
                 in_proc: dict, model, n_pages: int) -> dict:
    """Phase 8e: disaggregated serving on the card. The coordinator, a
    prefill worker (`--is-prefill-worker --prefill-queue`: it serves push
    and takes queue jobs), a decode worker (`--enable-disagg
    --max-local-prefill-length 256`) and the frontend (`--router-mode
    kv`), all on the phase-8 checkpoint; phase 8's 10 requests all in
    flight, first with the CUDA IPC plane, then with the decode worker
    restarted under DYN_KV_PLANE=0 (the host wire; every other request),
    then restarted with `--prefill-queue` and the plane on (every remote
    prefill rides the durable queue). Per request: its path, its pull and import seconds,
    bytes and GB/s by path; TTFT remote beside local. Checks: the plane
    carries every remote pull with 0 fallbacks; the wire set pulls over
    the wire; in the queue set the prefill worker took one job per remote
    request and no remote prefill failed; 0 KV-event gaps; every stream
    token-identical with phase 8's in-process batch or parting at a
    near-tie (BF16_TIE_TOL). Returns the prefill worker's kernel launches
    (its `_sys.stats` scrape) and the per-path pulls."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.runtime.distributed import free_port

    cfg = model.cfg
    with open(jobs) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    free, total = torch.cuda.mem_get_info()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    page_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.page_size
                  * cfg.head_dim * 2)
    pages = min(n_pages, int((free / 2 - weights - 2 * 2**30) // page_bytes))
    log(f"[disagg] before the workers start: {free / 2**30:.1f} GiB free of "
        f"{total / 2**30:.1f} GiB (this process holds phase 8's model); "
        f"each worker: {weights / 1e9:.2f} GB bf16 weights + "
        f"{pages * page_bytes / 1e9:.2f} GB KV pool ({pages} pages)")
    common = ["--model", ckpt, "--random-init", "--router-mode", "kv",
              "--num-pages", str(pages), "--max-batch-size", "8",
              "--prefill-chunk", "512", "--device", "cuda"]
    bodies = [{"model": "llama3-8b", "stream": True, "max_tokens": 32,
               "messages": [{"role": "user", "content": d["text"]}],
               **{k: v for k, v in d.items() if k != "text"}}
              for d in lines]
    services, sets = [], {}
    try:
        coord = Service(work, "coordinator", "--port", str(free_port()))
        services.append(coord)
        store = coord.wait_line("COORDINATOR_READY", 120)
        t0 = time.perf_counter()
        # the frontend binds a model name to the first card it sees: the
        # prefill pool publishes its own name
        prefill = Service(work, "worker", *common, "--store", store,
                          "--is-prefill-worker", "--prefill-queue",
                          "--instance-id", "11",
                          "--served-model-name", "llama3-8b-prefill",
                          label="prefill")
        services.append(prefill)

        def decode_worker(instance: int, env: dict,
                          *extra: str) -> "Service":
            w = Service(work, "worker", *common, "--store", store,
                        "--enable-disagg", "--max-local-prefill-length",
                        str(DISAGG_MAX_LOCAL), "--instance-id",
                        str(instance), "--served-model-name", "llama3-8b",
                        *extra, label=f"decode{instance}", env=env)
            services.append(w)
            return w

        decode = decode_worker(12, {})
        port = free_port()
        frontend = Service(work, "frontend", "--store", store, "--host",
                           "127.0.0.1", "--port", str(port),
                           "--router-mode", "kv")
        services.append(frontend)
        frontend.wait_line("FRONTEND_READY", 120)
        for w in (prefill, decode):
            ready = w.wait_line("WORKER_READY", 900)
            log(f"[disagg] {w.name} worker {ready} ready "
                f"{time.perf_counter() - t0:.1f} s after the start")

        def discovered():
            end = time.perf_counter() + 120
            while b'"llama3-8b"' not in _http_get(port, "/v1/models"):
                if time.perf_counter() > end:
                    raise AssertionError("the frontend never discovered "
                                         "the decode worker's card")
                time.sleep(0.2)
            time.sleep(1.0)       # the clients' watches see the instances

        discovered()
        free_now, _ = torch.cuda.mem_get_info()
        log(f"[disagg] with both workers up: {free_now / 2**30:.1f} GiB free "
            f"on the card ({(free - free_now) / 2**30:.1f} GiB taken by the "
            f"two workers and the frontend)")
        # the wire set runs every other request (3 remote, 2 local): its
        # pulls take seconds each, and the script's time limit is shared
        for label, env, extra, instance, idx in (
                ("plane", {}, (), 12, range(10)),
                ("wire", {"DYN_KV_PLANE": "0"}, (), 13, range(0, 10, 2)),
                ("queue", {}, ("--prefill-queue",), 14, range(10))):
            if instance != 12:
                decode.stop()
                services.remove(decode)
                decode = decode_worker(instance, env, *extra)
                decode.wait_line("WORKER_READY", 900)
                discovered()
            start_depth, stop_depth = queue_depth_sampler(
                store, "backend_prefill")
            start_depth()
            t_set = time.perf_counter()
            with ThreadPoolExecutor(len(idx)) as pool:
                streams = list(pool.map(
                    lambda i: http_chat_stream(port, bodies[i]), idx))
            wall = time.perf_counter() - t_set
            depth = stop_depth()
            for p in services:
                if p.proc.poll() is not None:
                    raise AssertionError(f"{p.name} exited: "
                                         f"{p.stderr_tail()}")
            time.sleep(0.5)       # the last log lines reach the files
            log_text = decode.stderr_tail(10**7)
            scrape = asyncio.run(worker_scrape(store))
            sets[label] = {"streams": streams, "wall": wall, "idx": idx,
                           "pulls": pull_records(log_text),
                           "imports": import_records(log_text),
                           "fell_back": log_text.count("kv pull fell back"),
                           "remote_failed": log_text.count(
                               "remote prefill failed"),
                           "depth": depth,
                           "decode": scrape[int(decode.name[6:])],
                           "prefill": scrape[11]}
        fe = _http_get(port, "/metrics").decode()
    finally:
        for p in reversed(services):
            p.stop()
    out = {"launches": {}}
    want = [token_ids_of(r["logprobs"]) for r in in_proc["results"]]
    jobs_before = 0
    for label, run in sets.items():
        streams = run["streams"]
        want_l = [want[i] for i in run["idx"]]
        remote = [s["prompt_tokens"] > DISAGG_MAX_LOCAL for s in streams]
        pulls = {p["tokens"]: p for p in run["pulls"]}
        imports = {i["tokens"]: i for i in run["imports"]}
        fallbacks = series_values(run["decode"],
                                  "dynamo_kv_pull_fallbacks_total")
        if len(run["pulls"]) != sum(remote) or any(
                s["prompt_tokens"] not in pulls
                for s, r in zip(streams, remote) if r):
            raise AssertionError(f"{label}: {len(run['pulls'])} pulls for "
                                 f"{sum(remote)} remote requests")
        paths = {p["path"] for p in run["pulls"]}
        path = "plane" if label == "queue" else label
        if paths != {path} or any(fallbacks.values()) or run["fell_back"] \
                or run["remote_failed"]:
            raise AssertionError(f"{label} set: pulls took {paths}, "
                                 f"fallbacks {fallbacks}, {run['fell_back']} "
                                 f"fallback log lines, "
                                 f"{run['remote_failed']} failed remote "
                                 f"prefills")
        jobs = series_values(run["prefill"], "dynamo_prefill_queue_jobs")
        done = int(jobs.get('{outcome="done"}', 0))
        taken, jobs_before = done - jobs_before, done
        if taken != (sum(remote) if label == "queue" else 0) \
                or jobs.get('{outcome="failed"}', 0):
            raise AssertionError(f"{label} set: the prefill worker took "
                                 f"{taken} queue jobs for {sum(remote)} "
                                 f"remote requests ({jobs})")
        if label == "queue":
            log(f"[disagg] queue set: every remote prefill rode the "
                f"prefill queue: {taken} jobs taken by the prefill worker "
                f"for {sum(remote)} remote requests, largest queue depth "
                f"seen {run['depth']}, 0 failed remote prefills")
        partings = []
        for r, ((ta, ka), s) in enumerate(zip(want_l, streams)):
            tb, kb = s["tokens"], s["tops"]
            n = min(len(ta), len(tb))
            if ta[:n] == tb[:n]:
                if len(ta) != len(tb):
                    raise AssertionError(f"{label} request {run['idx'][r]}: "
                                         f"{len(tb)} "
                                         f"tokens disaggregated, {len(ta)} "
                                         f"in process")
                continue
            for _, step, gap in stream_partings([(ta[:n], ka[:n])],
                                                [(tb[:n], kb[:n])],
                                                BF16_TIE_TOL):
                partings.append((r, step, gap))
        for r, s in enumerate(streams):
            p = pulls.get(s["prompt_tokens"]) if remote[r] else None
            i = imports.get(s["prompt_tokens"]) if remote[r] else None
            log(f"[disagg] {label} set, request {run['idx'][r]}: "
                f"{s['prompt_tokens']} prompt tokens, "
                + (f"remote: pulled by {p['path']} {p['bytes']} bytes in "
                   f"{p['seconds'] * 1e3:.2f} ms "
                   f"({p['bytes'] / p['seconds'] / 1e9:.2f} GB/s), import "
                   + (f"{i['seconds'] * 1e3:.3f} ms ({i['clock']} time)"
                      if i else "not logged")
                   if p else "local")
                + f"; TTFT {s['ttft_s'] * 1e3:.1f} ms, {len(s['tokens'])} "
                f"tokens")
        for r, step, gap in partings:
            log(f"[disagg] {label} set, request {run['idx'][r]} parts from the "
                f"in-process phase-path stream at step {step}: tokens "
                f"{want_l[r][0][step]} vs {streams[r]['tokens'][step]}, "
                f"logprob gap {gap:.4f} nats (tie tolerance {BF16_TIE_TOL}); "
                f"identical before it")
        ttft_r = [s["ttft_s"] * 1e3 for s, r in zip(streams, remote) if r]
        ttft_l = [s["ttft_s"] * 1e3 for s, r in zip(streams, remote) if not r]
        nbytes = sum(p["bytes"] for p in run["pulls"])
        secs = sum(p["seconds"] for p in run["pulls"])
        rows = [{"ttft_s": s["ttft_s"], "elapsed_s": s["elapsed_s"],
                 "n": len(s["tokens"])} for s in streams]
        log(f"[disagg] {label} set: {sum(remote)} remote, "
            f"{len(streams) - sum(remote)} local; TTFT p50 remote "
            f"{statistics.median(ttft_r):.1f} ms beside local "
            f"{statistics.median(ttft_l):.1f} ms; pulls {nbytes} bytes in "
            f"{secs * 1e3:.2f} ms ({nbytes / secs / 1e9:.2f} GB/s over the "
            f"pulls) by {path}; fallbacks {fallbacks or 0}; "
            f"{len(streams) - len(partings)} streams token-identical with "
            f"the in-process batch, {len(partings)} parted at near-ties; "
            f"{latency_summary(rows, run['wall'])}; on {smi}")
        out[label] = {"bytes": nbytes, "seconds": secs,
                      "pulls": len(run["pulls"])}
    launches = series_values(sets["queue"]["prefill"],
                             "dynamo_engine_kernel_launches")
    out["launches"] = {k.split('"')[1]: int(v) for k, v in launches.items()}
    if out["launches"].get("paged_kv_gather", 0) == 0:
        raise AssertionError(f"the prefill worker never launched the KV "
                             f"gather: {out['launches']}")
    decode_k3 = {k.split('"')[1]: int(v) for k, v in series_values(
        sets["wire"]["decode"], "dynamo_engine_kernel_launches").items()}
    gaps = series_values(fe, "dynamo_router_kv_event_gaps_total")
    dropped = series_values(fe, "dynamo_router_events_dropped_total")
    if any(gaps.values()) or any(dropped.values()):
        raise AssertionError(f"the router counted KV-event gaps {gaps} or "
                             f"dropped events {dropped}")
    log(f"[disagg] prefill worker kernel launches (the three sets, its "
        f"_sys.stats scrape): {out['launches']}; the wire set's decode "
        f"worker: {decode_k3}; KV-event gaps {gaps or 0}, dropped "
        f"{dropped or 0}; the wire set's prefill worker served its prompts "
        f"with a warm prefix cache (the same prompts as the plane set)")
    return out


# phase 8f: the KVBM pool and traffic. 320 pages of 16 tokens (+ scratch
# page 0) hold 0.63 GiB of Llama-3-8B KV; each prompt is a distinct
# 1024-byte prefix and its own 32-byte suffix (byte tokenizer: one token
# per byte, 66 pages), so the 12 prompts' 792 pages are 2.5x the pool
KVBM_PAGES = 321
KVBM_HOST_BLOCKS = 1024
KVBM_PROMPTS = 12


def kvbm_traffic(seed: int = 8) -> tuple[list, list, list]:
    """(prompts, warm-up prompt, fillers): printable bytes as token ids."""
    rng = random.Random(seed)

    def text(n):
        return [rng.randrange(32, 127) for _ in range(n)]

    prompts = [text(1024) + text(32) for _ in range(KVBM_PROMPTS)]
    return prompts, text(1056), [text(1056) for _ in range(5)]


def kvbm_phase(torch, smi: str, model) -> dict:
    """Phase 8f: KVBM on the card, in process (see the module docstring).
    Four passes on phase 8's weights, each a fresh phase-path engine
    (batch 8, chunk budget 512, 321 pages) with a KvbmManager: sync (every
    knob 0: cold, then the same 12 again), pipelined (queue 256, 2 IO
    workers, prefetch 64: two waves of 12 in flight), G3 (host 128 blocks,
    disk 1024: a revisit wave from disk) and G4 (two engines sharing the
    weights on one in-process runtime, each with a KvbmDistributed: B
    pulls what A offloaded). Returns the numbers PERF.md keeps."""
    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm import (
        KvbmConfig,
        KvbmDistributed,
        KvbmManager,
    )
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    cfg = model.cfg
    prompts, warm, fillers = kvbm_traffic()
    block_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.page_size
                   * cfg.head_dim * 2)
    first_hash = [TokenBlockSequence(cfg.page_size, p).seq_hashes()[0]
                  for p in prompts]
    out: dict = {}

    def make(**kvbm_kw):
        """A fresh engine with its memory ledger armed (KvbmManager
        registers its providers there) and a KvbmManager."""
        events = []
        with env_set(DYN_MEM_LEDGER="1"):
            eng = TorchEngine(TorchEngineConfig(
                model=cfg, num_pages=KVBM_PAGES, max_batch_size=8,
                prefill_chunk_budget=512, device="cuda"), model=model,
                event_sink=events.append)
        mgr = KvbmManager(eng, KvbmConfig(**kvbm_kw))
        return eng, mgr, events

    async def one(eng, prompt):
        """(tokens, top-8 per token) of one greedy request, max_tokens 8;
        a refusal or error fails the phase."""
        toks, tops = [], []
        async for o in eng.generate(
                {"token_ids": prompt,
                 "sampling": {"temperature": 0.0, "top_logprobs": 8},
                 "stop": {"max_tokens": 8}}, Context()):
            if o.get("finish_reason") == "error":
                raise AssertionError(f"8f request refused or failed: {o}")
            toks.extend(o.get("token_ids", ()))
            tops.extend(o.get("top_logprobs") or ())
        if len(toks) != 8:
            raise AssertionError(f"8f request gave {len(toks)} tokens")
        return toks, tops

    async def sequential(eng, ps):
        n0 = len(eng.ttft_s)
        streams = [await one(eng, p) for p in ps]
        return streams, [t * 1e3 for t in eng.ttft_s[n0:]]

    async def in_flight(eng, ps):
        n0 = len(eng.ttft_s)
        streams = await asyncio.gather(*(one(eng, p) for p in ps))
        return list(streams), [t * 1e3 for t in eng.ttft_s[n0:]]

    async def settle(eng, mgr):
        """No lane, pin or queued offload left."""
        while (eng.pool.active_pages or eng.pool.pending_offload_pages
               or mgr._offload_q_blocks):
            await asyncio.sleep(0.005)

    def check_events(label, events):
        ids = [e.event_id for e in events]
        if ids != list(range(1, len(ids) + 1)):
            gaps = sum(1 for a, b in zip(ids, ids[1:]) if b != a + 1)
            raise AssertionError(f"8f {label}: {gaps} KV-event gaps")
        kinds = [e.kind for e in events]
        return kinds.count("stored"), kinds.count("removed")

    def compare(label, cold, got) -> str:
        partings = stream_partings(cold, got, BF16_TIE_TOL)
        for r, step, gap in partings:
            log(f"[kvbm] {label}, request {r} parts from its cold stream at "
                f"step {step}: tokens {cold[r][0][step]} vs {got[r][0][step]}"
                f", logprob gap {gap:.4f} nats (tie tolerance "
                f"{BF16_TIE_TOL}); identical before it")
        return (f"{len(got) - len(partings)} streams token-identical with "
                f"their cold streams, {len(partings)} parted at near-ties")

    def p50(xs):
        return statistics.median(xs) if xs else float("nan")

    # each pass runs under a fresh process tracer (DYN_TRACE's, with a
    # file of its own): its kvbm.* spans are held to the pass's stats
    from dynamo_tpu_torch.runtime import tracing

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    spans_of: dict = {}

    def traced(label, coro_fn):
        path = os.path.join(trace_dir, f"{label}.jsonl")
        tr = tracing.Tracer(enabled=True, path=path)
        tracing.set_tracer(tr)
        try:
            res = asyncio.run(coro_fn())
        finally:
            tracing.set_tracer(None)
            asyncio.run(tr.close())
        if tr.dropped:
            raise AssertionError(f"8f {label}: the tracer dropped "
                                 f"{tr.dropped} spans")
        spans_of[label] = read_spans(path)
        return res

    def kvbm_blocks(label, name, source=None) -> int:
        return sum(int(span_attr(r, "kvbm.blocks"))
                   for r in spans_of[label] if r["name"] == name
                   and (source is None
                        or span_attr(r, "kvbm.source") == source))

    def onboard_events(label) -> int:
        return sum(int(next(a["value"]["stringValue"]
                            for a in e["attributes"] if a["key"] == "blocks"))
                   for r in spans_of[label] if r["name"] == "engine.request"
                   for e in r["events"] if e["name"] == "kvbm.onboard")

    # sync pass: every knob 0 ----------------------------------------------
    async def sync_pass():
        eng, mgr, events = make(host_blocks=KVBM_HOST_BLOCKS)
        try:
            await one(eng, warm)
            await settle(eng, mgr)
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            cold, ttft_cold = await sequential(eng, prompts)
            off_cold = mgr.stats.offloaded
            revisit, ttft_rev = await sequential(eng, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cuda_build.launch_counts()
            await settle(eng, mgr)
            return {"cold": cold, "revisit": revisit,
                    "ttft_cold": ttft_cold, "ttft_rev": ttft_rev,
                    "launches": launches, "wall": wall,
                    "stats": dict(vars(mgr.stats)), "off_cold": off_cold,
                    "status": mgr.status(),
                    # read after the close, which settles the last
                    # onboard's copy and K3
                    "stage": eng.metrics.kvbm_stage,
                    "stall": eng.metrics.admission_stall,
                    "events": check_events("sync pass", events),
                    "graphs": graph_summary(eng)}
        finally:
            await eng.close()

    s = traced("sync", sync_pass)
    if not (s["launches"]["paged_kv_gather"] > 0
            and s["launches"]["paged_kv_write_pages"] > 0):
        raise AssertionError(f"8f sync pass: the gather or K3 never "
                             f"launched: {s['launches']}")
    if s["stats"]["onboarded"] == 0 or s["off_cold"] == 0:
        raise AssertionError(f"8f sync pass offloaded or onboarded nothing: "
                             f"{s['stats']}")
    stage = {k: (h.count, h.mean() * 1e3) for k, h in s["stage"].items()}
    n_onboards = stage["onboard_stack"][0]
    n_offloads = stage["offload_gather"][0]
    if not (n_onboards == stage["onboard_copy"][0]
            == stage["onboard_write"][0] > 0 and n_offloads
            == stage["offload_copy"][0] == stage["offload_split"][0] > 0):
        raise AssertionError(f"8f sync pass: a transfer stage went untimed "
                             f"or never ran: {stage}")
    onboard_k3 = cfg.num_layers * n_onboards
    log(f"[kvbm] sync pass (every knob 0): cold TTFT p50 "
        f"{p50(s['ttft_cold']):.1f} ms (min {min(s['ttft_cold']):.1f}, max "
        f"{max(s['ttft_cold']):.1f}), revisit TTFT p50 "
        f"{p50(s['ttft_rev']):.1f} ms (min {min(s['ttft_rev']):.1f}, max "
        f"{max(s['ttft_rev']):.1f}); offloaded {s['stats']['offloaded']} "
        f"blocks ({s['off_cold']} during the cold wave), onboarded "
        f"{s['stats']['onboarded']} in {n_onboards} onboards "
        f"(queries {s['stats']['onboard_queries']}); admission stall p50 "
        f"{s['stall'].quantile(0.5) * 1e3:.3f} ms (bucket edge), mean "
        f"{s['stall'].mean() * 1e3:.3f} ms, sum "
        f"{s['stall'].sum * 1e3:.1f} ms over {s['stall'].count} admitted "
        f"requests; "
        f"{s['events'][0]} stored / {s['events'][1]} removed KV events, 0 "
        f"gaps; on {smi}")
    log(f"[kvbm] sync pass launches (zeroed before the cold wave, read "
        f"after the revisit wave): paged_kv_gather "
        f"{s['launches']['paged_kv_gather']}, paged_kv_write_pages "
        f"{s['launches']['paged_kv_write_pages']} ({onboard_k3} of them the "
        f"onboards' K3, one per layer per onboard), all {s['launches']}; "
        f"graphs {s['graphs']}")
    # mean blocks per onboard / offload read, mean ms per stage
    ob = s["stats"]["onboarded"] / n_onboards
    ofb = s["stats"]["offloaded"] / n_offloads
    osplit = {k: v[1] for k, v in stage.items()}
    log(f"[kvbm] inline offload reads (the sync pass's {n_offloads}, mean "
        f"{ofb:.1f} blocks): mean gather + block-order copy "
        f"{osplit['offload_gather']:.3f} ms, device-to-host "
        f"{osplit['offload_copy']:.3f} ms "
        f"({ofb * block_bytes / osplit['offload_copy'] / 1e6:.2f} GB/s), "
        f"host split into blocks {osplit['offload_split']:.3f} ms "
        f"(EngineMetrics.kvbm_stage); on {smi}")
    log(f"[kvbm] onboard split, mean over {n_onboards} onboards of "
        f"{ob:.1f} blocks ({ob * block_bytes / 2**20:.0f} MiB): host stack "
        f"{osplit['onboard_stack']:.3f} ms, host-to-device "
        f"{osplit['onboard_copy']:.3f} ms "
        f"({ob * block_bytes / osplit['onboard_copy'] / 1e6:.2f} GB/s), K3 x "
        f"{cfg.num_layers} {osplit['onboard_write']:.3f} ms "
        f"({osplit['onboard_write'] / cfg.num_layers:.4f} ms per launch; "
        f"EngineMetrics.kvbm_stage); revisit vs cold: "
        f"{compare('sync revisit', s['cold'], s['revisit'])}; on {smi}")
    cold = s["cold"]
    out["sync"] = {"ttft_cold_p50": p50(s["ttft_cold"]),
                   "ttft_revisit_p50": p50(s["ttft_rev"]),
                   "split_mean_ms": osplit, "stats": s["stats"],
                   "launches": s["launches"]}

    # pipelined pass --------------------------------------------------------
    async def pipelined_pass():
        eng, mgr, events = make(host_blocks=KVBM_HOST_BLOCKS,
                                offload_queue_depth=256, offload_workers=2,
                                prefetch_blocks=64)
        pins, done = [0], [False]
        peaks = {"kvbm_pinned": 0, "kvbm_staged": 0}

        async def watch():
            n = 0
            while not done[0]:
                pins[0] = max(pins[0], eng.pool.pending_offload_pages)
                if n % 5 == 0:
                    # the ledger's KVBM providers, read by a poll
                    classes = eng.memory_ledger.poll()["classes"]
                    for k in peaks:
                        peaks[k] = max(peaks[k], classes[k])
                n += 1
                await asyncio.sleep(0.001)

        watcher = asyncio.get_running_loop().create_task(watch())
        try:
            # no warm-up: the graphs capture while offloads run
            w1, t1 = await in_flight(eng, prompts)
            w2, t2 = await in_flight(eng, prompts)
            await settle(eng, mgr)
            done[0] = True
            await watcher
            return {"w1": w1, "w2": w2, "t1": t1, "t2": t2,
                    "pins": pins[0], "peaks": peaks,
                    "stats": dict(vars(mgr.stats)),
                    "pending": eng.pool.pending_offload_pages,
                    "stall": eng.metrics.admission_stall,
                    "events": check_events("pipelined pass", events),
                    "graphs": graph_summary(eng)}
        finally:
            done[0] = True
            await eng.close()

    pl = traced("pipelined", pipelined_pass)
    if pl["pending"] != 0 or pl["pins"] == 0:
        raise AssertionError(f"8f pipelined pass: {pl['pending']} pages "
                             f"still pinned at the end, {pl['pins']} seen")
    # the worker offloaded every eviction and the revisits onboarded
    # staged blocks: a failed gather or onboard would show as a miss here
    # (and a device failure fails the requests: `one` raises)
    ps = pl["stats"]
    if not (ps["offloaded"] > 0 and ps["onboarded"] > 0
            and ps["prefetch_hits"] > 0 and ps["offload_inline"] == 0):
        raise AssertionError(f"8f pipelined pass: offloads, onboards or "
                             f"prefetch hits missing, or inline offloads: "
                             f"{ps}")
    log(f"[kvbm] pipelined pass (queue 256, 2 IO workers, prefetch 64; 12 "
        f"in flight, twice): wave 1 TTFT p50 {p50(pl['t1']):.1f} ms (graph "
        f"captures inside), wave 2 TTFT p50 {p50(pl['t2']):.1f} ms; offload "
        f"pins seen up to {pl['pins']}, offloaded "
        f"{pl['stats']['offloaded']}, offload_inline "
        f"{pl['stats']['offload_inline']}, prefetched "
        f"{pl['stats']['prefetched']}, prefetch_hits "
        f"{pl['stats']['prefetch_hits']}, onboarded "
        f"{pl['stats']['onboarded']}; pending_offload_pages at the end "
        f"{pl['pending']}; admission stall p50 "
        f"{pl['stall'].quantile(0.5) * 1e3:.3f} ms, mean "
        f"{pl['stall'].mean() * 1e3:.3f} ms over {pl['stall'].count}; "
        f"{pl['events'][0]} stored / {pl['events'][1]} removed KV events, 0 "
        f"gaps; wave 1: {compare('pipelined wave 1', cold, pl['w1'])}; "
        f"wave 2: {compare('pipelined wave 2', cold, pl['w2'])}; graphs "
        f"{pl['graphs']}; on {smi}")
    log(f"[kvbm] memory ledger armed on every 8f engine: peaks over the "
        f"pipelined pass's polls (one per ~5 ms) kvbm_pinned "
        f"{pl['peaks']['kvbm_pinned']} B, kvbm_staged "
        f"{pl['peaks']['kvbm_staged']} B ({block_bytes} B a block); on {smi}")
    out["pipelined"] = {"ttft_w1_p50": p50(pl["t1"]),
                        "ttft_w2_p50": p50(pl["t2"]), "pins": pl["pins"],
                        "stats": pl["stats"]}

    # G3 pass: host 128 blocks, disk 1024 ---------------------------------
    async def disk_pass(disk_dir):
        eng, mgr, events = make(host_blocks=128, disk_blocks=1024,
                                disk_dir=disk_dir)
        try:
            await one(eng, warm)
            await sequential(eng, prompts)
            await settle(eng, mgr)
            rows = []
            for i, p in enumerate(prompts):
                h = first_hash[i]
                tier = ("g1" if eng.pool.match_prefix([h]) else
                        "g2" if mgr.store.host.contains(h) else
                        "g3" if mgr.store.disk is not None
                        and mgr.store.disk.contains(h) else "none")
                before = mgr.stats.onboarded
                got, ttft = await sequential(eng, [p])
                rows.append((tier, ttft[0], got[0],
                             mgr.stats.onboarded - before))
                await settle(eng, mgr)
            return {"rows": rows, "stats": dict(vars(mgr.stats)),
                    "status": mgr.status(),
                    "events": check_events("G3 pass", events)}
        finally:
            await eng.close()

    disk_dir = tempfile.mkdtemp(prefix="chip_smoke_kvbm_")
    try:
        g3 = traced("g3", lambda: disk_pass(disk_dir))
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)
    from_disk = [t for tier, t, _, _ in g3["rows"] if tier == "g3"]
    if not from_disk or any(n == 0 for tier, _, _, n in g3["rows"]
                            if tier == "g3"):
        raise AssertionError(f"8f G3 pass: a revisit held on disk onboarded "
                             f"nothing: {[(r[0], r[3]) for r in g3['rows']]}")
    log(f"[kvbm] G3 pass (host 128 blocks, disk 1024 in a temporary "
        f"directory): revisit tiers {[r[0] for r in g3['rows']]}; TTFT p50 "
        f"of the {len(from_disk)} onboards from disk {p50(from_disk):.1f} ms"
        f" (min {min(from_disk):.1f}, max {max(from_disk):.1f}); all "
        f"revisits {p50([r[1] for r in g3['rows']]):.1f} ms; tiers "
        f"{ {k: v for k, v in g3['status'].items() if k in ('g2', 'g3')} };"
        f" onboarded {g3['stats']['onboarded']}; "
        f"{compare('G3 revisit', cold, [r[2] for r in g3['rows']])}; on "
        f"{smi}")
    out["g3"] = {"ttft_disk_p50": p50(from_disk), "n_disk": len(from_disk)}

    # G4 pass: B pulls what A offloaded ------------------------------------
    async def remote_pass():
        rt = await DistributedRuntime.create(
            RuntimeConfig(store_url="memory", lease_ttl=60.0))
        a, mgr_a, ev_a = make(host_blocks=KVBM_HOST_BLOCKS)
        b, mgr_b, ev_b = make(host_blocks=KVBM_HOST_BLOCKS)
        dist_a = KvbmDistributed(mgr_a, rt, "dynamo", "backend",
                                 worker_id=1)
        dist_b = KvbmDistributed(mgr_b, rt, "dynamo", "backend",
                                 worker_id=2)
        pulls = []
        fetch = dist_b.fetch

        async def timed_fetch(hashes, expect_shape=None):
            t0 = time.perf_counter()
            got = await fetch(hashes, expect_shape=expect_shape)
            pulls.append((len(hashes), len(got), time.perf_counter() - t0))
            return got

        dist_b.fetch = timed_fetch
        try:
            await dist_a.start()
            await dist_b.start()
            await one(a, warm)
            await one(b, warm)
            await sequential(a, prompts)
            # push the last prompts' pages off A's device into its tier,
            # then drop what is left there (a clear forgets, it does not
            # offload)
            await sequential(a, fillers)
            await settle(a, mgr_a)
            a.clear_kv_blocks()
            await dist_a._publish()
            held = sum(mgr_a.store.contains(h) for h in first_hash)
            rows = []
            for p in prompts:
                before = mgr_b.stats.remote_onboarded
                n_pulls = len(pulls)
                got, ttft = await sequential(b, [p])
                rows.append((mgr_b.stats.remote_onboarded - before,
                             pulls[n_pulls:], ttft[0], got[0]))
                await settle(b, mgr_b)
            return {"rows": rows, "held": held,
                    "events": (check_events("G4 pass, engine A", ev_a),
                               check_events("G4 pass, engine B", ev_b))}
        finally:
            for x in (dist_a, dist_b, a, b, rt):
                await x.close()

    g4 = traced("g4", remote_pass)
    shutil.rmtree(trace_dir, ignore_errors=True)
    # the spans against the stats of the same passes: the sync path's
    # inline offloads run under no span (as the reference's), the
    # pipelined worker's batches each under one
    span_rows = {
        "sync": (kvbm_blocks("sync", "kvbm.onboard", "local"),
                 s["stats"]["onboarded"], kvbm_blocks("sync", "kvbm.offload"),
                 0, onboard_events("sync")),
        "pipelined": (kvbm_blocks("pipelined", "kvbm.onboard", "local"),
                      pl["stats"]["onboarded"],
                      kvbm_blocks("pipelined", "kvbm.offload"),
                      pl["stats"]["offloaded"], onboard_events("pipelined")),
        "g3": (kvbm_blocks("g3", "kvbm.onboard", "local"),
               g3["stats"]["onboarded"], kvbm_blocks("g3", "kvbm.offload"), 0,
               onboard_events("g3")),
    }
    remote = (kvbm_blocks("g4", "kvbm.onboard", "remote"),
              sum(r[0] for r in g4["rows"]))
    bad = {k: v for k, v in span_rows.items()
           if v[0] != v[1] or v[2] != v[3] or v[4] != v[1]}
    if bad or remote[0] != remote[1] or not (span_rows["pipelined"][2]
                                             and remote[0]):
        raise AssertionError(f"8f kvbm spans vs stats (onboard spans, "
                             f"onboarded, offload spans, worker offloads, "
                             f"onboard events): {span_rows}; remote "
                             f"{remote}")
    n_spans = {name: sum(1 for r in spans_of["pipelined"]
                         if r["name"] == name)
               for name in ("kvbm.offload", "kvbm.prefetch")}
    table = {k: {"kvbm.onboard blocks": v[0], "onboarded": v[1],
                 "kvbm.offload blocks": v[2]} for k, v in span_rows.items()}
    log(f"[kvbm] traced passes, spans against the manager's stats: "
        f"{table}; the request roots' kvbm.onboard events add up to the "
        f"same; pipelined pass spans {n_spans}; G4 remote kvbm.onboard "
        f"blocks {remote[0]} = remote-onboarded {remote[1]}; on {smi}")
    if g4["held"] != KVBM_PROMPTS or sum(r[0] for r in g4["rows"]) == 0:
        raise AssertionError(f"8f G4 pass: engine A's tiers held "
                             f"{g4['held']} of {KVBM_PROMPTS} prompts, engine "
                             f"B remote-onboarded "
                             f"{sum(r[0] for r in g4['rows'])} blocks")
    for i, (n, pulls, ttft, _) in enumerate(g4["rows"]):
        desc = "; ".join(
            f"asked {asked}, got {got} in {sec * 1e3:.1f} ms "
            f"({got * block_bytes / sec / 1e9:.3f} GB/s)"
            for asked, got, sec in pulls) or "no pull"
        log(f"[kvbm] G4 pass, engine B request {i}: {n} blocks "
            f"remote-onboarded ({desc}); TTFT {ttft:.1f} ms beside its cold "
            f"TTFT {s['ttft_cold'][i]:.1f} ms")
    remote = [r for r in g4["rows"] if r[0]]
    pulled = [p for r in g4["rows"] for p in r[1]]
    nbytes = sum(got for _, got, _ in pulled) * block_bytes
    secs = sum(sec for _, _, sec in pulled)
    log(f"[kvbm] G4 pass: engine A's tiers held {g4['held']} of the 12 "
        f"prompts' first blocks after the fillers and the clear; engine B "
        f"remote-onboarded {sum(r[0] for r in g4['rows'])} blocks for "
        f"{len(remote)} requests, {len(pulled)} pulls moved "
        f"{nbytes / 2**20:.0f} MiB in {secs:.3f} s "
        f"({nbytes / max(secs, 1e-9) / 1e9:.3f} GB/s; fetch timeout 2.0 s, "
        f"partial runs kept); B's TTFT p50 "
        f"{p50([r[2] for r in g4['rows']]):.1f} ms (remote-onboarded "
        f"requests {p50([r[2] for r in remote]):.1f} ms) beside its cold "
        f"TTFT p50 {p50(s['ttft_cold']):.1f} ms; "
        f"{compare('G4', cold, [r[3] for r in g4['rows']])}; KV events A "
        f"{g4['events'][0]}, B {g4['events'][1]} (stored, removed), 0 gaps; "
        f"on {smi}")
    out["g4"] = {"remote_onboarded": sum(r[0] for r in g4["rows"]),
                 "bytes": nbytes, "seconds": secs,
                 "ttft_p50": p50([r[2] for r in g4["rows"]])}
    return out


def _http_get(port: int, path: str) -> bytes:
    return _http_status(port, path)[1]


def graph_stats(eng) -> dict:
    """An engine's CUDA graphs so far (`engine/graphs.py`): the entries and
    shapes captured, the captures' seconds from the compile tracker (each
    the first dispatch of its key: warm-up, capture, first replay), the
    replays and the shared pool's bytes."""
    keys = sorted(eng.graphs.graphs)
    entries = sorted({k[0] for k in keys})
    by_entry = {e: [sum(1 for k in keys if k[0] == e), 0.0] for e in entries}
    for lab, v in eng.compile_tracker.compile_seconds.items():
        if lab["entry"] in by_entry:
            by_entry[lab["entry"]][1] += v
    return {"entries": entries, "shapes": [k[1] for k in keys],
            "captures": eng.graphs.captures, "replays": eng.graphs.replays,
            "capture_s": sum(sec for _, sec in by_entry.values()),
            "by_entry": {e: tuple(v) for e, v in by_entry.items()},
            "pool": eng.graphs.pool_bytes()}


def graph_summary(eng) -> str:
    g = graph_stats(eng)
    return (f"graphs: {g['captures']} captures of {g['entries']} at "
            f"{g['shapes']} in {g['capture_s']:.3f} s (first dispatches, "
            f"compile tracker), {g['replays']} replays, pool {g['pool']} "
            f"bytes")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "paged_attention_core" in low:     # the bf16 core: <D, kDecode>
        return ("K4 paged_attention_decode" if "true>" in low
                else "K1 ragged_paged_attention")
    if "paged_decode" in low or "decode_combine" in low:
        return "K4 paged_attention_decode"
    if any(w in low for w in ("ragged_tile", "ragged_fp32", "combine")):
        return "K1 ragged_paged_attention"
    if "paged_kv_write_pages" in low:
        return "K3 paged_kv_write_pages"
    if "paged_kv_write" in low:
        return "K2 paged_kv_write"
    if "w8a8_gemm" in low:
        return "K5 w8a8_matmul GEMM"
    if "int4_gemm" in low:
        return "K6 int4_matmul GEMM"
    if "quantize_rows" in low:
        return "K5/K6 row quantize"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "sort" in low or "radix" in low:
        return "sort (sampling top-k)"
    return "other (elementwise, norms, softmax, sampling)"


def profile_rounds(torch, llama, graphs, model, dev, n_pad_mixed: int,
                   labels=("decode", "mixed", "burst"), mode: str = "bf16"):
    """Bare device steps of `model` outside the engine, as the engine runs
    them: host arrays copied to the card, the step, the packed result
    copied back (its one sync) — a ragged decode round and a ragged mixed
    round, the phase path's 8-step decode burst over the same 8 lanes,
    its "prefill" chunk rounds (bp 1 and bp 8 at T 512, aligned), its
    "mixed_step" (a 512-token aligned chunk beside the 8-lane 8-step
    burst) and its "sample_first" (8 lanes at the full vocabulary) (those
    of `labels`). Each step is also captured in a CUDA graph
    (`graphs.StepGraphs`, as the engine does) on a copy of the caches,
    held bit-identical with the eager step on another copy (phase 11a),
    and measured as a replay. Returns {label: (eager, graphed, replay ms
    by CUDA events, pool bytes)}, eager and graphed each (wall_ms, busy_ms,
    device ops per step, {class: ms}, [(ms, kernel), ...] top 5); busy_ms
    is None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import sampling

    cfg = model.cfg
    P, bmax = cfg.page_size, 8
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    kc, vc = llama.init_cache(cfg, 1 + 72 * (bmax + 1), dev)
    for cache in kc + vc:           # attention over real-valued keys
        cache.normal_()

    def host_round(chunk: int):
        """(chunk rows of lane 0 at positions chunk..2*chunk-1) + the
        decode block of 8 lanes, padded to chunk + 8 + n_pad rows."""
        # lane 0 = the chunk's, lanes bmax.. = decode; 72 own pages each
        tables = torch.zeros(2 * bmax, cfg.max_pages_per_seq,
                             dtype=torch.int32)
        for i, lane in enumerate([0, *range(bmax, 2 * bmax)]):
            tables[lane, :72] = torch.arange(1 + 72 * i, 73 + 72 * i)
        pos = list(range(chunk, 2 * chunk)) + [c - 1 for c in ctx]
        lane = [0] * chunk + list(range(bmax, 2 * bmax))
        pad = n_pad_mixed if chunk else 0
        pos_t = torch.tensor(pos + [0] * pad, dtype=torch.int32)
        lane_t = torch.tensor(lane + [0] * pad, dtype=torch.int32)
        valid = torch.arange(pos_t.numel()) < len(pos)
        pages = tables[lane_t.long(), (pos_t // P).long()]
        z = torch.zeros(bmax, dtype=torch.int64)
        return [torch.randint(0, cfg.vocab_size, (pos_t.numel(),),
                              dtype=torch.int32), pos_t, pages, pos_t % P,
                valid, lane_t, tables,
                torch.tensor([max(chunk - 1, 0)] * bmax, dtype=torch.int32),
                torch.arange(chunk, chunk + bmax, dtype=torch.int32), z, z,
                torch.zeros(bmax), torch.ones(bmax), z]

    def one(k_cache, v_cache):
        return lambda *a: llama.ragged_prefill_decode(model, k_cache,
                                                      v_cache, *a)

    def burst(k_cache, v_cache):
        return lambda *a: llama.decode_multi_step(model, k_cache, v_cache,
                                                  *a, num_steps=8)

    def packed_of(out):
        return out[0] if isinstance(out, tuple) else out

    # the phase path's burst: the same 8 decode lanes, 8 fused steps
    tables = torch.zeros(bmax, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(bmax):
        tables[i, :72] = torch.arange(73 + 72 * i, 145 + 72 * i)
    z = torch.zeros(bmax, dtype=torch.int64)
    burst_args = [torch.randint(0, cfg.vocab_size, (bmax,),
                                dtype=torch.int32),
                  torch.tensor(ctx, dtype=torch.int32) - 1, tables,
                  torch.ones(bmax, dtype=torch.bool), z, z,
                  torch.zeros(bmax), torch.ones(bmax), z]
    def prefill(k_cache, v_cache):
        return lambda *a: llama.prefill_batch(model, k_cache, v_cache, *a,
                                              aligned=True)

    def prefill_args(bp):
        """bp lanes of one aligned 512-token chunk from cursor 0, pages
        1 + 32 i .. of lane i."""
        t = torch.zeros(bp, cfg.max_pages_per_seq, dtype=torch.int32)
        for i in range(bp):
            t[i, :32] = torch.arange(1 + 32 * i, 33 + 32 * i)
        return [torch.randint(0, cfg.vocab_size, (bp, 512),
                              dtype=torch.int32), t,
                torch.zeros(bp, dtype=torch.int32),
                torch.full((bp,), 512, dtype=torch.int32)]

    def mixed_step(k_cache, v_cache):
        return lambda *a: llama.mixed_prefill_decode(
            model, k_cache, v_cache, *a, num_steps=8, aligned=True)

    def mixed_step_args():
        """Lane 0's second 512-token chunk (cursor 512, pages 1..64) beside
        the burst's 8 decode lanes."""
        t = torch.zeros(1, cfg.max_pages_per_seq, dtype=torch.int32)
        t[0, :64] = torch.arange(1, 65)
        return [torch.randint(0, cfg.vocab_size, (1, 512),
                              dtype=torch.int32), t,
                torch.tensor([512], dtype=torch.int32),
                torch.tensor([1024], dtype=torch.int32), *burst_args]

    def sample_first(k_cache, v_cache):
        return lambda *a: sampling.sample_tokens_lp(*a)

    def sample_args():
        return [torch.randn(bmax, cfg.vocab_size) * 4,
                torch.arange(bmax, dtype=torch.int64) + 11, z,
                torch.tensor([0.0, 0.7, 1.0, 0.0, 0.9, 0.0, 1.2, 0.0]),
                torch.tensor([1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 1.0, 1.0]),
                torch.tensor([0, 0, 40, 0, 0, 0, 0, 0]), torch.zeros(bmax)]

    steps = {"decode": (one, lambda: host_round(0)),
             "mixed": (one, lambda: host_round(512)),
             "burst": (burst, lambda: burst_args),
             "prefill1": (prefill, lambda: prefill_args(1)),
             "prefill8": (prefill, lambda: prefill_args(8)),
             "mixed_step": (mixed_step, mixed_step_args),
             "sample_first": (sample_first, sample_args)}
    out = {}
    with torch.inference_mode():
        for label in labels:
            fn, make = steps[label]
            args = make()
            host = [a.numpy() for a in args]
            eager = measure(torch, lambda: packed_of(fn(kc, vc)(
                *(a.to(dev) for a in args))).cpu(), ProfilerActivity,
                profile, reps=(EAGER_PROFILE_REPS if mode == "bf16"
                               else QUANT_PROFILE_REPS))
            # 11a: the graph on one copy of the caches, eager on another
            g_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
            e_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
            step_graphs = graphs.StepGraphs(dev)
            t0 = time.perf_counter()
            got = step_graphs.run((label,), fn(*g_caches), host)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            want = fn(*e_caches)(*(a.to(dev) for a in args))
            torch.cuda.synchronize()
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(g, w) for g, w in zip(got_t, want_t)):
                raise AssertionError(f"{mode} {label}: the graph replay "
                                     f"differs from the eager step")
            for g, w in zip(g_caches[0] + g_caches[1],
                            e_caches[0] + e_caches[1]):
                if not torch.equal(g[:, 1:], w[:, 1:]):
                    raise AssertionError(f"{mode} {label}: the graph left "
                                         f"other caches than the eager step")
            n_out = len(got_t)
            del e_caches, want, want_t, got_t
            log(f"[graph] {mode} {label} (8B, bare): captured in "
                f"{capture_s:.3f} s (warm-up + capture + first replay), "
                f"replay bit-identical with the eager step ({n_out} "
                f"output(s), both caches outside page 0)")

            def replay():
                return packed_of(step_graphs.run(
                    (label,), None, host)).cpu()

            graphed = measure(torch, replay, ProfilerActivity, profile,
                              reps=GRAPH_PROFILE_REPS if mode == "bf16"
                              else QUANT_PROFILE_REPS)
            ev = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                replay()
                end.record()
                end.synchronize()
                ev.append(start.elapsed_time(end))
            out[label] = (eager, graphed, statistics.median(ev),
                          step_graphs.pool_bytes())
            del step_graphs, g_caches, got
            torch.cuda.empty_cache()
    del kc, vc
    return out


def profile_spec(torch, llama, graphs, model, draft, dev):
    """Phase 11a / 11 for the spec burst: a bare 8-lane burst (gamma
    SPEC_GAMMA, SPEC_ITERS iterations, greedy, the burst lanes of
    `profile_rounds`) of `model` verifying `draft`'s proposals, captured
    in a CUDA graph on copies of both cache pairs and held bit-identical
    with the eager burst on other copies (packed output, all four caches
    outside page 0), then its replay measured as `profile_rounds`
    measures a graphed step (eager, the burst issues tens of thousands of
    launches: not measured). Returns (None, graphed, replay ms by CUDA
    events, pool bytes)."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine.spec import spec_decode_multi_step

    cfg, bmax = model.cfg, 8
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    n_pages = 1 + 72 * bmax
    caches = [*llama.init_cache(cfg, n_pages, dev),
              *llama.init_cache(draft.cfg, n_pages, dev)]
    for c in caches:
        for t in c:
            t.normal_()
    tables = torch.zeros(bmax, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(bmax):
        tables[i, :72] = torch.arange(1 + 72 * i, 73 + 72 * i)
    z = torch.zeros(bmax, dtype=torch.int64)
    args = [torch.randint(0, cfg.vocab_size, (bmax,), dtype=torch.int32),
            torch.tensor(ctx, dtype=torch.int32) - 1, tables,
            torch.ones(bmax, dtype=torch.bool),
            torch.arange(bmax, dtype=torch.int64) * 7 + 1, z,
            torch.zeros(bmax), torch.ones(bmax), z]
    host = [a.numpy() for a in args]

    def fn(cs):
        return lambda *a: spec_decode_multi_step(
            model, draft, *cs, *a, gamma=SPEC_GAMMA,
            num_iters=SPEC_ITERS)[0]

    with torch.inference_mode():
        g_caches = [[t.clone() for t in c] for c in caches]
        e_caches = [[t.clone() for t in c] for c in caches]
        step_graphs = graphs.StepGraphs(dev)
        t0 = time.perf_counter()
        got = step_graphs.run(("spec",), fn(g_caches), host)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        want = fn(e_caches)(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("the spec burst's graph replay differs from "
                                 "the eager burst")
        for g, e in zip(g_caches, e_caches):
            for tg, te in zip(g, e):
                if not torch.equal(tg[:, 1:], te[:, 1:]):
                    raise AssertionError("the spec burst's graph left other "
                                         "caches than the eager burst")
        del e_caches, want
        log(f"[graph] bf16 spec burst (8B + 1B draft, 8 lanes, gamma "
            f"{SPEC_GAMMA}, {SPEC_ITERS} iterations, bare): captured in "
            f"{capture_s:.3f} s (warm-up + capture + first replay), replay "
            f"bit-identical with the eager burst (packed output, target and "
            f"draft caches outside page 0)")

        def replay():
            return step_graphs.run(("spec",), None, host).cpu()

        graphed = measure(torch, replay, ProfilerActivity, profile, reps=1)
        ev = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            replay()
            end.record()
            end.synchronize()
            ev.append(start.elapsed_time(end))
        pool = step_graphs.pool_bytes()
        del step_graphs, g_caches, got, caches
    torch.cuda.empty_cache()
    return None, graphed, statistics.median(ev), pool


def draft_verify_disagreement(torch, llama, model, dev, n_steps: int = 80):
    """How often a self-draft's proposal and the verify's argmax part, at
    the same positions: 8 lanes of random prompts (the contexts of the
    bare steps) prefilled, then `n_steps` greedy decode steps of `model`
    (K2 + K4, as the draft steps) on one copy of the caches, and on
    another copy the same tokens fed through gamma + 1-row forwards (K2 +
    K1's chunk rows, as the verify). Returns (positions compared, the
    positions where the two argmaxes differ, the verify's largest logit
    gap between its own argmax and the decode's at those positions)."""
    cfg, g1 = model.cfg, SPEC_GAMMA + 1
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    b = len(ctx)
    gen = torch.Generator().manual_seed(5)
    tables = torch.zeros(b, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(b):
        tables[i, :72] = torch.arange(1 + 72 * i, 73 + 72 * i)
    tables = tables.to(dev)
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, max(ctx)), generator=gen,
                           dtype=torch.int32).to(dev)
    with torch.inference_mode():
        kc, vc = llama.init_cache(cfg, 1 + 72 * b, dev)
        first = torch.argmax(llama.prefill_batch(
            model, kc, vc, prompt, tables, torch.zeros_like(lens), lens), -1)
        verify_kv = ([c.clone() for c in kc], [c.clone() for c in vc])
        valid = torch.ones(b, dtype=torch.bool, device=dev)
        fed, dec = [first.to(torch.int32)], []
        for t in range(n_steps):
            logits = llama._decode_once(model, kc, vc, fed[-1], lens + t,
                                        tables, valid)
            dec.append(torch.argmax(logits, -1).to(torch.int32))
            fed.append(dec[-1])
        fed = torch.stack(fed[:n_steps], 1)
        dec = torch.stack(dec, 1)
        differ, gaps = 0, [0.0]
        for c in range(0, n_steps, g1):
            x = llama.paged_forward(model, *verify_kv,
                                    fed[:, c:c + g1].contiguous(), tables,
                                    lens + c, lens + c + g1)
            logits = llama.qm(x, model.lm_head).float()
            top, own = logits.max(-1)
            want = dec[:, c:c + g1]
            gap = top - logits.gather(-1, want[..., None].long())[..., 0]
            off = own.to(torch.int32) != want
            differ += int(off.sum())
            gaps += gap[off].tolist()
        del kc, vc, verify_kv
    torch.cuda.empty_cache()
    return dec.numel(), differ, max(gaps)


def self_draft_floor(p: float, n_pos: int, n_iters: int,
                     gamma: int = SPEC_GAMMA) -> tuple[float, float]:
    """The self-draft's acceptance floor from the measured rate `p` (over
    `n_pos` positions) at which the draft's and the verify's argmaxes
    part: a greedy iteration accepts k < gamma proposals with probability
    (1 - p)^k p and all gamma with (1 - p)^gamma (a rejection discards
    the rest of its iteration). The floor is that law's mean acceptance
    at p three standard errors above the measured rate, less three
    standard deviations of the mean over `n_iters` iterations. Returns
    (floor, the mean acceptance at the measured p)."""
    def law(q):
        return [(1 - q) ** k * q for k in range(gamma)] + [(1 - q) ** gamma]

    p_hi = min(1.0, p + 3 * math.sqrt(max(p * (1 - p), 1 / n_pos) / n_pos))
    probs = law(p_hi)
    mean = sum(k / gamma * w for k, w in enumerate(probs))
    var = sum((k / gamma) ** 2 * w for k, w in enumerate(probs)) - mean ** 2
    return (mean - 3 * math.sqrt(max(var, 0.0) / max(n_iters, 1)),
            sum(k / gamma * w for k, w in enumerate(law(p))))


# profiled repetitions of each bare eager bf16 step in phase 11 (cut from
# 5 since phase 8c's parser run was added, to 2, and to none since 8d's
# recorders and 8j were added: the eager walls stay), of the bf16 graphed
# steps (cut from 5 since 8c, 8d, 8f and 8i check the request tracer),
# and of the quantized bursts' eager and graphed runs (cut from 2 and 5
# since phase 8h was added, and to none since 8k was added: their walls,
# graph checks and CUDA-event replay times stay)
EAGER_PROFILE_REPS = 0
GRAPH_PROFILE_REPS = 2
QUANT_PROFILE_REPS = 0


def measure(torch, step, ProfilerActivity, profile, reps: int = 5):
    """Host wall (median of 10) of `step` (which ends in its one sync),
    then `reps` more under torch.profiler (none when 0): (wall_ms, busy_ms
    or None, device ops per step, {class: ms}, top 5 [(ms, kernel)])."""
    for _ in range(3):
        step()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        walls.append(1e3 * (time.perf_counter() - t0))
    if not reps:
        return statistics.median(walls), None, None, {}, []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
    by_class, n_kernels, top = {}, 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / reps
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_kernels += e.count
        top.append((ms, e.key))
    busy = sum(by_class.values()) or None
    return (statistics.median(walls), busy, n_kernels / reps, by_class,
            sorted(top, reverse=True)[:5])


@contextlib.contextmanager
def plain_path(ragged, kernels, attention, int4_mm, torch, graphs=None,
               keep_k1=False):
    """Swap every kernel's wrapper for its plain version (with `keep_k1`,
    every one but K1 and the prefill attention it serves), and with
    `graphs` (engine/graphs.py) run the engine's graphed steps eagerly:
    the plain versions read lengths on the host, which a capture cannot
    (this script's comparison only; the package has no such switch)."""
    names = ((kernels, "paged_kv_write"),
             (kernels, "paged_kv_write_pages"),
             (attention, "paged_attention_decode"),
             (int4_mm, "w8a8_matmul"), (int4_mm, "int4_matmul"),
             (int4_mm, "w8a8_matmul_group"), (int4_mm, "int4_matmul_group"))
    if not keep_k1:
        names += ((ragged, "ragged_paged_attention"),
                  (attention, "prefill_attention"))
    if graphs is not None:
        names += ((graphs.StepGraphs, "run"),)
    saved = [getattr(mod, name) for mod, name in names]
    if graphs is not None:
        graphs.StepGraphs.run = lambda self, key, fn, inputs: fn(*(
            graphs._tensor(a).to(self.device) for a in inputs))
    if not keep_k1:
        ragged.ragged_paged_attention = blocked_plain_attention(ragged, torch)
        ref = attention.prefill_attention_ref
        # the plain version takes no row tags (it counts visible pages)
        attention.prefill_attention = lambda *a: ref(*a[:7])
    kernels.paged_kv_write = kernels.paged_kv_write_ref
    kernels.paged_kv_write_pages = kernels.paged_kv_write_pages_ref
    attention.paged_attention_decode = attention.paged_attention_decode_ref
    int4_mm.w8a8_matmul = int4_mm.w8a8_matmul_ref
    int4_mm.int4_matmul = int4_mm.int4_matmul_ref
    int4_mm.w8a8_matmul_group = lambda x, ws: [
        int4_mm.w8a8_matmul_ref(x, q, s) for q, s in ws]
    int4_mm.int4_matmul_group = lambda x, ws: [
        int4_mm.int4_matmul_ref(x, p, s) for p, s in ws]
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def stream_partings(a, b, tol: float) -> list:
    """[(request, step, gap)] where greedy streams `a` and `b` (lists of
    (tokens, top-k [[id, logprob], ...] per token) per request) part;
    raises unless at every parting each run ranks the other's token within
    `tol` nats of its own choice (a near-tie; past it the two continue from
    different tokens and are not compared)."""
    def gap(top, mine, theirs):
        lp = dict((int(i), v) for i, v in top)
        return lp[mine] - lp[theirs] if theirs in lp else float("inf")

    partings = []
    for r, ((ta, ka), (tb, kb)) in enumerate(zip(a, b)):
        if len(ta) != len(tb):
            raise AssertionError(f"request {r}: {len(ta)} vs {len(tb)} tokens")
        step = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    None)
        if step is None:
            continue
        x, y = ta[step], tb[step]
        g = max(gap(ka[step], x, y), gap(kb[step], y, x))
        if not g <= tol:
            raise AssertionError(f"request {r} parts at step {step}: tokens "
                                 f"{x} vs {y}, logprob gap {g}")
        partings.append((r, step, g))
    return partings


def a8_fns(int4_mm, mode: str):
    """(kernel wrapper, plain version) of a quantized mode."""
    return ((int4_mm.w8a8_matmul, int4_mm.w8a8_matmul_ref) if mode == "w8a8"
            else (int4_mm.int4_matmul, int4_mm.int4_matmul_ref))


def a8_case(torch, gen, dev, m, k, dtype):
    """Activations of mixed row scales for K5/K6, row 0 all zeros (its
    scale sits at the 1e-12 floor), row 2 with an outlier."""
    x = torch.randn(m, k, generator=gen)
    x *= torch.logspace(-3, 2, m)[:, None]
    x[0] = 0.0
    if m > 2:
        x[2, k // 3] = 500.0
    return x.to(dev, dtype)


def check_quantized(torch, quant, model, mode: str) -> None:
    """Every projection is held as int8 (w8a8) or packed int4 only, with
    its mode's activation bits; no layer holds a float tensor larger than
    a norm or a bias."""
    bits, act = quant._bits_of(mode), quant._act_bits_of(mode)
    cfg = model.cfg
    for layer in model.layers:
        for key in quant.QUANT_KEYS:
            w = getattr(layer, key)
            k, n = w.shape
            if not (isinstance(w, quant.QTensor) and w.bits == bits
                    and w.act_bits == act and w.q.dtype == torch.int8
                    and tuple(w.q.shape) == (n * bits // 8, k)):
                raise AssertionError(f"{mode}: {key} is not held as "
                                     f"{bits}-bit weights: {w}")
        for t in layer.parameters():
            if t.numel() > cfg.num_heads * cfg.head_dim:
                raise AssertionError(f"{mode}: a layer holds a float tensor "
                                     f"of {tuple(t.shape)}")


# The constrained batch (phase 8b): one lane of each kind, the byte
# tokenizer's EOS (256) as each request's stop id, as the preprocessor adds
# it. The presence penalty sits far above the random weights' logit
# spread, so that lane may not repeat a letter.
BYTE_EOS = 256
CONSTRAINED_LANES = (
    ("choice", {"guided": {"choice": ["yes", "no", "maybe"]}}),
    ("regex", {"guided": {"regex": r"[a-z]+( [a-z]+){0,7}\."}}),
    ("json", {"guided": {"json": True}}),
    ("presence", {"guided": {"regex": "[a-z]+"}, "presence_penalty": 50.0}),
    ("repetition", {"repetition_penalty": 1.3}),
    ("min_p", {"min_p": 0.1, "temperature": 0.8, "seed": 1234}),
    ("free", {}),
    ("free", {}),
)
CONSTRAINED_MAX_TOKENS = 32


def constrained_requests(top: int = 0) -> list:
    """The constrained batch as engine requests, byte prompts of 20..89
    tokens from a seed; `top` asks every lane for its top logprobs."""
    rng = random.Random(8)
    reqs = []
    for _, sampling in CONSTRAINED_LANES:
        prompt = [rng.randrange(32, 127)
                  for _ in range(rng.randrange(20, 90))]
        reqs.append({"token_ids": prompt,
                     "sampling": {"temperature": 0.0, "top_logprobs": top,
                                  **sampling},
                     "stop": {"max_tokens": CONSTRAINED_MAX_TOKENS,
                              "stop_token_ids": [BYTE_EOS]}})
    return reqs


async def serve_requests(eng, Context, reqs) -> list:
    """Every request in flight at once: per request (tokens, finish
    reason, top logprobs per token, chosen logprobs)."""
    async def one(r):
        toks, tops, lps, finish = [], [], [], None
        async for o in eng.generate(r, Context()):
            if o.get("finish_reason") == "error":
                raise AssertionError(f"request failed: {o}")
            toks.extend(o.get("token_ids", ()))
            tops.extend(o.get("top_logprobs") or ())
            lps.extend(o.get("log_probs") or ())
            finish = o.get("finish_reason") or finish
        return toks, finish, tops, lps
    return list(await asyncio.gather(*(one(r) for r in reqs)))


def lane_dfas(guided) -> dict:
    """Each guided lane's byte DFA, compiled here from its spec (the
    check does not read the engine's token tables)."""
    out = {}
    for label, sampling in CONSTRAINED_LANES:
        spec = sampling.get("guided")
        if spec is not None:
            out[label] = guided.compile_regex(
                guided.choice_regex(spec["choice"]) if "choice" in spec
                else spec.get("regex") or guided.json_regex())
    return out


def check_constrained(guided, dfas, outs, label_of_run: str) -> str:
    """Every guided lane inside its grammar (a full match where it
    stopped), the presence lane with no letter twice, the other lanes at
    full length or stopped; returns a one-line summary."""
    summary = []
    for (label, _), (toks, finish, _, _) in zip(CONSTRAINED_LANES, outs):
        body = toks[:-1] if finish == "stop" and toks[-1:] == [BYTE_EOS] \
            else toks
        if label not in dfas:
            if not (finish == "stop" or
                    (finish == "length"
                     and len(toks) == CONSTRAINED_MAX_TOKENS)):
                raise AssertionError(f"{label_of_run} {label} lane: "
                                     f"{len(toks)} tokens, {finish}")
            summary.append(f"{label} {finish} {len(toks)} tokens")
            continue
        if any(not 0 <= t < 256 for t in body):
            raise AssertionError(f"{label_of_run} {label} lane emitted a "
                                 f"token outside its grammar: {toks}")
        data, s = bytes(body), 0
        for byte in data:
            s = int(dfas[label].next[s, byte])
            if s < 0:
                raise AssertionError(f"{label_of_run} {label} lane left its "
                                     f"grammar: {data!r}")
        if finish == "stop" and not guided.match_bytes(dfas[label], data):
            raise AssertionError(f"{label_of_run} {label} lane stopped "
                                 f"short of a match: {data!r}")
        if finish not in ("stop", "length"):
            raise AssertionError(f"{label_of_run} {label} lane: {finish}")
        if label == "presence" and len(set(data)) != len(data):
            raise AssertionError(f"{label_of_run} presence lane repeated a "
                                 f"letter: {data!r}")
        summary.append(f"{label} {finish} {data[:48]!r}")
    return "; ".join(summary)


def seed_grammars(eng, compiled: dict, vocab) -> None:
    """A fresh engine's grammar cache filled with tables the first engine
    compiled for the same vocabulary (a JSON-mode compile at vocab 128256
    takes seconds; this script's comparison only)."""
    eng._guided_vocab = vocab
    for i, (key, tables) in enumerate(compiled.items()):
        eng._guided_tables[key] = tables
        eng._guided_slots[key] = i + 1


def constrained_partings(a, b, tol: float) -> list:
    """[(lane, step, gap)] where two runs of the constrained batch part
    (each run a `serve_requests` result). A greedy lane may part only at a
    near-tie: each run ranks the other's token within `tol` nats of its
    own. The sampled lane may part only where both runs sample from the
    same distribution: the same chosen logprobs within `tol` at every
    step before the parting, the same logprobs within `tol` on the top-8
    tokens both runs list at the parting, and each run's token one that
    min_p keeps there (a different Gumbel winner at a near-tie of the
    perturbed scores; its token is rarely in the other run's top 8, since
    min_p keeps many tokens of a random model's flat distribution)."""
    partings = []
    for (label, sampling), ra, rb in zip(CONSTRAINED_LANES, a, b):
        ta, tb = ra[0], rb[0]
        step = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    None)
        if step is None:
            if len(ta) != len(tb):
                raise AssertionError(f"{label} lane: {len(ta)} vs {len(tb)} "
                                     f"tokens with no parting")
            continue
        x, y = ta[step], tb[step]
        lp_a = dict((int(i), v) for i, v in ra[2][step])
        lp_b = dict((int(i), v) for i, v in rb[2][step])
        t = sampling.get("temperature", 0.0)
        if t > 0:
            shared = set(lp_a) & set(lp_b)
            floor = t * math.log(sampling["min_p"])
            gap = max([abs(ra[3][i] - rb[3][i]) for i in range(step)]
                      + [abs(lp_a[k] - lp_b[k]) for k in shared]
                      + [max(lp.values()) + floor - chosen
                         for lp, chosen in ((lp_a, ra[3][step]),
                                            (lp_b, rb[3][step]))]
                      if shared else [float("inf")])
        else:
            lp_a.setdefault(x, ra[3][step])
            lp_b.setdefault(y, rb[3][step])
            gap = max(lp_a[x] - lp_a.get(y, -math.inf),
                      lp_b[y] - lp_b.get(x, -math.inf))
        if not gap <= tol:
            raise AssertionError(f"{label} lane parts at step {step}: tokens "
                                 f"{x} vs {y}, gap {gap}")
        partings.append((label, step, gap))
    return partings


def constrained_phase(torch, model, dev, smi, n_pages: int) -> dict:
    """Phase 8b: the constrained batch at Llama-3-8B's full width on the
    phase engine and on the ragged engine; the bare "decode_guided" step
    replayed against eager; its profile beside the plain burst's; the
    constrained head's device time per step. Returns the compiled grammars
    and their vocabulary for phase 12."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from dynamo_tpu_torch.engine import cuda_build, graphs, sampling
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm import guided
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.runtime.context import Context

    cfg = model.cfg
    V = cfg.vocab_size
    t0 = time.perf_counter()
    dfas = lane_dfas(guided)
    log(f"[constrained] the lanes' byte DFAs for the output checks in "
        f"{time.perf_counter() - t0:.2f} s")
    specs = [s["guided"] for _, s in CONSTRAINED_LANES if "guided" in s]
    out = {"dfas": dfas}

    def engine(impl):
        return TorchEngine(TorchEngineConfig(
            model=cfg, num_pages=n_pages, max_batch_size=8,
            prefill_chunk_budget=512, attention_impl=impl, device="cuda"),
            model=model, token_bytes=lambda: guided.token_bytes_of(
                ByteTokenizer(), V), eos_token_id=BYTE_EOS)

    for impl in ("phase", "ragged"):
        eng = engine(impl)
        prefill_kernel = ("paged_kv_write_pages" if impl == "phase"
                          else "ragged_paged_attention")

        async def go():
            try:
                compile_s = {}
                if impl == "phase":
                    for spec in specs:
                        t0 = time.perf_counter()
                        await eng._compile_guided(spec)
                        compile_s[json.dumps(spec)] = \
                            time.perf_counter() - t0
                else:
                    seed_grammars(eng, out["compiled"], out["vocab"])
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                outs = await serve_requests(eng, Context,
                                            constrained_requests())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = cuda_build.launch_counts()
                keys = sorted(k for k in eng.graphs.graphs
                              if k[0] == "decode_guided")
                replays = eng.graphs.replays
                again = await serve_requests(
                    eng, Context, [constrained_requests()[5]] * 2)
                return compile_s, outs, wall, launches, keys, replays, again
            finally:
                await eng.close()

        compile_s, outs, wall, launches, keys, replays, again = \
            asyncio.run(go())
        summary = check_constrained(guided, dfas, outs, impl)
        for kname in ("paged_kv_write", "paged_attention_decode",
                      prefill_kernel):
            if launches[kname] == 0:
                raise AssertionError(f"kernel {kname} never launched on the "
                                     f"{impl} constrained path")
        rows = eng._guided_layout()[0]
        if keys != [("decode_guided", (8, 8, 0, rows))]:
            raise AssertionError(f"{impl}: decode_guided captures {keys}, "
                                 f"want one at row bucket {rows}")
        if again[0][0] != again[1][0] or \
                len(again[0][0]) != CONSTRAINED_MAX_TOKENS:
            raise AssertionError(f"{impl}: the same seeded request twice: "
                                 f"{again[0][0]} vs {again[1][0]}")
        cap_s = sum(v for lab, v in
                    eng.compile_tracker.compile_seconds.items()
                    if lab["entry"] == "decode_guided")
        table_bytes = sum(t.nbytes for b in eng._guided_buffers.values()
                          for t in b[:3])
        log(f"[constrained] {impl} path, Llama-3-8B bf16 random weights, 8 "
            f"lanes x {CONSTRAINED_MAX_TOKENS} tokens in {wall:.2f} s: "
            f"{summary}")
        log(f"[constrained] {impl} path: launches {launches}; "
            f"{len(keys)} decode_guided capture(s) {keys} in {cap_s:.3f} s "
            f"(first dispatch, compile tracker), {replays} replays in the "
            f"batch; resident guided tables {table_bytes} bytes "
            f"({rows} rows x (2V + V/8 + 1)); the same seeded min_p "
            f"request twice: identical ({again[0][0][:6]}...); on {smi}")
        if impl == "phase":
            json_s = compile_s[json.dumps({"json": True})]
            n_json = eng._guided_tables[
                eng._guided_key({"json": True})].num_states
            log(f"[constrained] grammar compiles through the engine's host "
                f"pool at vocab {V}: " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in compile_s.items())
                + f"; JSON mode {json_s:.3f} s, {n_json} states, on the "
                f"host of the {smi} ({os.cpu_count()} cores)")
            out.update(compiled=dict(eng._guided_tables),
                       vocab=eng._guided_vocab, json_s=json_s,
                       table_bytes=table_bytes)
            layout = eng._guided_layout()
            stack = eng._guided_device_stack(layout)
            row_of = {key: row for key, row, _ in layout[1]}
            key_of = eng._guided_key
        del eng
        torch.cuda.empty_cache()

    # the bare "decode_guided" step: 8 lanes at contexts 44..1033 — JSON,
    # choice, regex and [a-z]+ lanes at their grammars' first rows, then
    # the repetition, min_p and two free lanes
    bmax = 8
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    kc, vc = llama.init_cache(cfg, 1 + 72 * bmax, dev)
    for cache in kc + vc:
        cache.normal_()
    tables = np.zeros((bmax, cfg.max_pages_per_seq), np.int32)
    for i in range(bmax):
        tables[i, :72] = np.arange(1 + 72 * i, 73 + 72 * i)
    rng = np.random.default_rng(8)
    lane_rows = [row_of[key_of(s)] for s in
                 ({"json": True}, specs[0], specs[1], specs[3])] + [0] * 4
    pc = np.zeros((bmax, V), np.int32)
    pc[:, 32:127] = rng.integers(0, 3, (bmax, 95))
    stop = np.full((bmax, 8), -1, np.int32)
    stop[:, 0] = BYTE_EOS
    z = np.zeros(bmax, np.int64)
    plain_in = [rng.integers(0, 256, bmax).astype(np.int32),
                np.asarray(ctx, np.int32) - 1, tables,
                np.ones(bmax, bool), np.arange(bmax, dtype=np.int64) * 7, z,
                np.array([0, 0, 0, 0, 0, 0.8, 0, 0], np.float32),
                np.ones(bmax, np.float32), z]
    guided_in = plain_in + [
        np.array([0, 0, 0, 0, 0, 0.1, 0, 0], np.float32),
        np.array([1, 1, 1, 1, 1.3, 1, 1, 1], np.float32),
        np.zeros(bmax, np.float32),
        np.array([0, 0, 0, 50, 0, 0, 0, 0], np.float32), pc,
        np.zeros((bmax, V), np.int32), np.zeros(bmax, np.int32),
        np.asarray(lane_rows, np.int32), stop]

    def guided_step(k_cache, v_cache):
        return lambda *a: llama.decode_multi_step_guided(
            model, k_cache, v_cache, *a[:15], *stack, *a[15:], num_steps=8)

    def plain_step(k_cache, v_cache):
        return lambda *a: llama.decode_multi_step(model, k_cache, v_cache,
                                                  *a, num_steps=8)

    with torch.inference_mode():
        g_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
        e_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
        sg = graphs.StepGraphs(dev)
        second = list(guided_in)
        second[0] = (second[0] + 17) % 256
        second[-2] = np.asarray([r + 1 if r else 0 for r in lane_rows],
                                np.int32)
        for i, inputs in enumerate((guided_in, second)):
            t0 = time.perf_counter()
            got = sg.run(("decode_guided",), guided_step(*g_caches), inputs)
            torch.cuda.synchronize()
            if i == 0:
                capture_s = time.perf_counter() - t0
            want = guided_step(*e_caches)(
                *(torch.from_numpy(a).to(dev) for a in inputs))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError("the decode_guided replay differs from "
                                     "the eager burst")
            for buf, a in zip(sg.graphs[("decode_guided",)].inputs, inputs):
                if not torch.equal(buf.cpu(), torch.from_numpy(a)):
                    raise AssertionError("the decode_guided replay wrote "
                                         "one of its static inputs")
            for g, w in zip(g_caches[0] + g_caches[1],
                            e_caches[0] + e_caches[1]):
                if not torch.equal(g[:, 1:], w[:, 1:]):
                    raise AssertionError("the decode_guided graph left other "
                                         "caches than the eager burst")
        toks = got[0].cpu().numpy().astype(int)
        log(f"[graph] decode_guided (8B, bare, 8 lanes x 8 steps): captured "
            f"in {capture_s:.3f} s (warm-up + capture + first replay); two "
            f"replays bit-identical with the eager burst (packed output, "
            f"both caches outside page 0), static inputs unchanged after "
            f"each; JSON lane {bytes(t for t in toks[:, 0] if t < 256)!r}")
        del e_caches, want
        sp = graphs.StepGraphs(dev)
        sp.run(("decode_burst",), plain_step(*g_caches), plain_in)
        rows = {}
        for label, sgr, key, inputs in (
                ("decode_burst", sp, ("decode_burst",), plain_in),
                ("decode_guided", sg, ("decode_guided",), guided_in)):
            rows[label] = measure(
                torch, lambda: sgr.run(key, None, inputs).cpu(),
                ProfilerActivity, profile)
        # the constrained head: every op after the last layer's lm_head
        # (penalties, grammar mask, sampling), profiled in an eager burst
        names = ("constrained_logits", "sample_tokens_lp")
        saved = {n: getattr(sampling, n) for n in names}

        def annotated(n):
            def run(*a, **kw):
                with record_function(f"head::{n}"):
                    return saved[n](*a, **kw)
            return run

        head, eager_ops = {}, {}
        try:
            for n in names:
                setattr(sampling, n, annotated(n))
            for label, step, inputs in (
                    ("decode_burst", plain_step(*g_caches), plain_in),
                    ("decode_guided", guided_step(*g_caches), guided_in)):
                dev_in = [torch.from_numpy(a).to(dev) for a in inputs]
                step(*dev_in)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step(*dev_in)
                    torch.cuda.synchronize()
                events = prof.key_averages()
                head[label] = sum(
                    e.device_time_total for e in events
                    if e.key.startswith("head::")
                    and e.device_type == torch.autograd.DeviceType.CPU) \
                    / 1e3 / 8
                eager_ops[label] = sum(
                    e.count for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 8
        finally:
            for n in names:
                setattr(sampling, n, saved[n])
    for label, (wall_ms, busy, n_k, by_class, top) in rows.items():
        busy_txt = "not measured" if busy is None else \
            f"{busy:.2f} ms, idle {100 * max(0.0, 1 - busy / wall_ms):.1f}%"
        log(f"[constrained] {label} (8B bf16, bare, 8 lanes x 8 steps, "
            f"graphed): wall {wall_ms:.2f} ms (median of 10), device busy "
            f"{busy_txt}, {n_k:.0f} device ops ({n_k / 8:.0f} per step), "
            f"on {smi}")
    g_busy = rows["decode_guided"][1]
    for label, ms in head.items():
        what = ("penalties + grammar mask + sampling"
                if label == "decode_guided" else "sampling")
        if not ms:
            log(f"[constrained] {label}: the ops after the last layer "
                f"({what}): device time not measured (the profiler saw "
                f"none); on {smi}")
            continue
        share = (f", {100 * 8 * ms / g_busy:.2f}% of the graphed guided "
                 f"burst's busy" if g_busy and label == "decode_guided"
                 else "")
        log(f"[constrained] {label}: the ops after the last layer ({what}) "
            f"{ms:.4f} ms of device time per step (eager profile){share}; "
            f"{eager_ops[label]:.0f} device ops per step eager; on {smi}")
    out.update(rows=rows, head=head)
    del g_caches, kc, vc, sg, sp, stack
    torch.cuda.empty_cache()
    return out


# phase 8h: Mixtral-8x7B's published shape (mistralai/Mixtral-8x7B-v0.1
# config.json; models/mixtral.py MoeConfig.mixtral_8x7b), served in int8
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 32000,
    "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "max_position_embeddings": 32768, "num_local_experts": 8,
    "num_experts_per_tok": 2, "tie_word_embeddings": False,
}
# the KV pool: 4096 pages of 16 tokens, 2 MiB a page (32 layers x K and V
# x 8 heads x 16 x 128 x bf16): 8 GiB beside the ~47 GB of int8 weights
MOE_PAGES = 4096
# image ids 30000..31023 (codebook 1024): inside Mixtral's vocabulary
IMAGE_OFFSET = 30000
DEFAULT_IMAGE_OFFSET = 128256       # the encode worker's default
MOE_TEXT_BYTES = (16, 40, 100, 200, 350, 600)
MOE_MAX_TOKENS = 16
# moe_mlp (bf16 activations, bf16 or int8 stacks) against the fp32
# per-token loop: gate, up and their product round to bf16 (0.8% of the
# output's largest value on the CPU at hidden 256); a token whose k-th and
# (k+1)-th fp32 router logits lie within ROUTER_TIE_TOL may route
# otherwise from the bf16 router product and is counted, not compared
MOE_BF16_TOL = 0.02
ROUTER_TIE_TOL = 0.05
# Greedy bf16 Mixtral streams of one request on two paths or two prefill
# schedules (phase vs ragged, in process vs the worker's prefill-all):
# random weights at vocab 32000 give flat distributions, and 32 layers of
# int8 experts carry each path's bf16 roundings to the logits. Where two
# streams part, each run ranks the other's token within this many nats of
# its own (partings measured at 0.0156-0.2812 nats over 11 partings on an
# NVIDIA H100 80GB HBM3, 700 W; a wrong MoE product moves logits by O(1))
MOE_TIE_TOL = 0.5


def png_rgb(w: int, h: int, seed: int) -> bytes:
    """A random 8-bit RGB PNG written with the standard library (zlib),
    rows under filters None and Sub in turn."""
    import struct
    import zlib

    rng = random.Random(seed)
    raw = bytearray()
    for y in range(h):
        row = bytes(rng.randrange(256) for _ in range(3 * w))
        if y % 2:
            raw.append(1)
            raw.extend((row[i] - (row[i - 3] if i >= 3 else 0)) % 256
                       for i in range(len(row)))
        else:
            raw.append(0)
            raw.extend(row)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def moe_requests(name: str, url: str) -> tuple[list, list, dict]:
    """Phase 8h's chats: 6 greedy text chats of 16..600 bytes, the same
    image chat twice, one image chat for the default-offset card; each
    max_tokens 16 with top-8 logprobs (GREEDY_FIELDS)."""
    rng = random.Random(5)
    texts = ["".join(rng.choice("abcdefghij klmnop qrstuv wxyz.,")
                     for _ in range(n)) for n in MOE_TEXT_BYTES]

    def chat(content, model=name):
        return {"model": model, "stream": True, "max_tokens": MOE_MAX_TOKENS,
                **GREEDY_FIELDS,
                "messages": [{"role": "user", "content": content}]}

    image = [{"type": "text", "text": "what is in this picture?"},
             {"type": "image_url", "image_url": {"url": url}}]
    return ([chat(t) for t in texts], [chat(image), chat(image)],
            chat(image, name + "-default-offset"))


async def chat_in_process(pipeline, body: dict) -> dict:
    """One chat through an in-process pipeline, read as
    `http_chat_stream` reads an HTTP stream."""
    from dynamo_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()
    entries, first, finish, usage = [], None, None, None
    async for chunk in pipeline.generate({"_kind": "chat", "body": body},
                                         Context()):
        for ch in chunk.get("choices", ()):
            got = (ch.get("logprobs") or {}).get("content") or []
            if got and first is None:
                first = time.perf_counter() - t0
            entries.extend(got)
            finish = ch.get("finish_reason") or finish
        usage = chunk.get("usage") or usage
    toks, tops = token_ids_of(entries)
    if finish is None or usage is None or first is None \
            or usage["completion_tokens"] != len(toks):
        raise AssertionError(f"in-process chat ended badly: {finish}, "
                             f"{usage}, {len(toks)} tokens")
    return {"tokens": toks, "tops": tops, "finish": finish,
            "ttft_s": first, "elapsed_s": time.perf_counter() - t0,
            "t0": t0, "prompt_tokens": usage["prompt_tokens"]}


def moe_mlp_check(torch, mixtral, layer, cfg, dev, label: str) -> str:
    """`moe_mlp` at one layer on the card against `moe_mlp_reference` (the
    fp32 per-token loop, int8 stacks read dequantized) on 32 tokens of
    bf16 activations: within MOE_BF16_TOL of the output's largest value,
    tokens at a router near-tie (ROUTER_TIE_TOL) counted apart."""
    gen = torch.Generator(device=dev).manual_seed(11)
    h = torch.randn((32, cfg.hidden_size), generator=gen,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        got = mixtral.moe_mlp(h, layer, cfg).float()
        want = mixtral.moe_mlp_reference(h, layer, cfg)
        logits = h.float() @ layer.router.float()
    if not torch.isfinite(got).all() or got.shape != h.shape:
        raise AssertionError(f"{label}: moe_mlp output is not finite")
    top = logits.sort(dim=-1, descending=True).values
    k = cfg.experts_per_token
    clear = (top[:, k - 1] - top[:, k]) >= ROUTER_TIE_TOL
    if clear.sum() < 16:
        raise AssertionError(f"{label}: {int((~clear).sum())} of 32 tokens "
                             f"at a router near-tie")
    err = (got - want).abs().amax(dim=-1)[clear].max().item()
    scale = want.abs().max().item()
    if not err <= MOE_BF16_TOL * scale:
        raise AssertionError(f"{label}: moe_mlp differs from the reference "
                             f"loop by {err} (largest output {scale})")
    return (f"{label}: max |moe_mlp - moe_mlp_reference| {err:.5f} over "
            f"{int(clear.sum())} of 32 tokens (largest output {scale:.4f}, "
            f"tolerance {MOE_BF16_TOL} x it; "
            f"{int((~clear).sum())} at a router near-tie below "
            f"{ROUTER_TIE_TOL})")


def moe_burst_profile(torch, llama, mixtral, graphs, model, dev,
                      smi: str) -> dict:
    """One bare 8-lane, 8-step decode burst of the served Mixtral model
    (contexts 44..1033, top-8 logprobs): eager, then captured in a CUDA
    graph and replayed (bit-identical with the eager burst on a copy of
    the caches). Prints the replay's host wall (with its one sync), its
    device busy time, and the eager burst's device time split into the
    MoE FFN (expert GEMMs, the int8 → bf16 conversion of the stacks,
    their scales, and routing / gating / combine) beside attention
    (K2 + K4) and the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = model.cfg
    bmax, k = 8, 8
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    kc, vc = llama.init_cache(cfg, 1 + 72 * bmax, dev)
    for cache in kc + vc:
        cache.normal_()
    tables = torch.zeros(bmax, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(bmax):
        tables[i, :72] = torch.arange(1 + 72 * i, 73 + 72 * i)
    z = torch.zeros(bmax, dtype=torch.int64)
    args = [torch.randint(0, cfg.vocab_size, (bmax,), dtype=torch.int32),
            torch.tensor(ctx, dtype=torch.int32) - 1, tables,
            torch.ones(bmax, dtype=torch.bool), z, z, torch.zeros(bmax),
            torch.ones(bmax), z]
    host = [a.numpy() for a in args]

    def burst(k_cache, v_cache):
        return lambda *a: llama.decode_multi_step(
            model, k_cache, v_cache, *a, num_steps=k, topk_lp=8)

    out = {}
    with torch.inference_mode():
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            burst(kc, vc)(*(a.to(dev) for a in args)).cpu()
            walls.append(1e3 * (time.perf_counter() - t0))
        out["eager_wall_ms"] = min(walls)
        # the eager burst under the profiler, each MoE FFN and each expert
        # product in a range of its own (this script's wrappers only)
        names = ("moe_mlp", "_qe_in", "_qe_out")
        orig = {n: getattr(mixtral, n) for n in names}

        def ranged(label, fn):
            def run(*a, **kw):
                with record_function(label):
                    return fn(*a, **kw)
            return run

        for n in names:
            setattr(mixtral, n, ranged("moe:" + n, orig[n]))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                burst(kc, vc)(*(a.to(dev) for a in args)).cpu()
        finally:
            for n in names:
                setattr(mixtral, n, orig[n])

        def kernels_of(evt):
            ks = list(evt.kernels)
            for ch in evt.cpu_children:
                ks += kernels_of(ch)
            return ks

        # every device kernel (the hand-written ones launch outside any
        # aten op, so only the device events see them; the ranges' own
        # device spans left out), then the MoE ranges' kernels through the
        # op tree
        dev_events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("moe:")]
        total = sum(e.self_device_time_total for e in dev_events)
        events = prof.events()
        moe = [kn for e in events if e.name == "moe:moe_mlp"
               for kn in kernels_of(e)]
        expert = [kn for e in events
                  if e.name in ("moe:_qe_in", "moe:_qe_out")
                  for kn in kernels_of(e)]
        split = {"expert GEMMs": 0.0, "int8 -> bf16 conversion": 0.0,
                 "scales": 0.0}
        for kn in expert:
            cls = kernel_class(kn.name)
            key = ("expert GEMMs" if cls == "matmul (cuBLAS)" else
                   "int8 -> bf16 conversion" if "copy" in kn.name.lower()
                   else "scales")
            split[key] += kn.duration
        moe_us = sum(kn.duration for kn in moe)
        split["routing, gating, combine"] = moe_us - sum(split.values())
        attn_us = sum(e.self_device_time_total for e in dev_events
                      if kernel_class(e.key).startswith(("K2", "K4")))
        out.update(total_ms=total / 1e3, moe_ms=moe_us / 1e3,
                   attn_ms=attn_us / 1e3,
                   other_ms=(total - moe_us - attn_us) / 1e3,
                   split={key: v / 1e3 for key, v in split.items()},
                   launches=sum(e.count for e in dev_events))
        if not moe_us > 0 or not total > moe_us:
            raise AssertionError(f"the profiler saw no MoE kernel: {out}")
        # the graphed burst: bit-identical with the eager one, then timed
        step_graphs = graphs.StepGraphs(dev)
        g_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
        eager_caches = ([c.clone() for c in kc], [c.clone() for c in vc])
        want = burst(*eager_caches)(*(a.to(dev) for a in args)).cpu()
        t0 = time.perf_counter()
        got = step_graphs.run(("burst",), burst(*g_caches), host).cpu()
        out["capture_s"] = time.perf_counter() - t0
        if not torch.equal(got, want):
            raise AssertionError("the graphed MoE burst differs from the "
                                 "eager burst")
        for a, b in zip(g_caches[0] + g_caches[1],
                        eager_caches[0] + eager_caches[1]):
            if not torch.equal(a[:, 1:], b[:, 1:]):
                raise AssertionError("the graphed MoE burst left other "
                                     "caches than the eager burst")
        del eager_caches

        def replay():
            return step_graphs.run(("burst",), None, host).cpu()

        walls, ev = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            replay()
            walls.append(1e3 * (time.perf_counter() - t0))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step_graphs.run(("burst",), None, host)
            end.record()
            end.synchronize()
            ev.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out.update(graph_wall_ms=statistics.median(walls),
                   graph_event_ms=statistics.median(ev),
                   graph_busy_ms=busy or None,
                   pool=step_graphs.pool_bytes())
        del step_graphs, g_caches, got
    del kc, vc
    torch.cuda.empty_cache()
    sp = out["split"]
    busy = out["graph_busy_ms"]
    busy_txt = ("device busy not measured (the profiler saw no kernel in "
                "the replay)" if not busy else
                f"{busy:.2f} ms device busy (idle share "
                f"{1 - busy / out['graph_wall_ms']:.3f})"
                if busy < out["graph_wall_ms"] else
                f"{busy:.2f} ms device busy under the profiler, above the "
                f"unprofiled wall: no idle time measurable")
    log(f"[moe] bare 8-lane 8-step decode burst of Mixtral-8x7B int8 "
        f"(contexts 44..1033, top-8 logprobs): graph captured in "
        f"{out['capture_s']:.2f} s (warm-up + capture + first replay), the "
        f"replay bit-identical with the eager burst; replayed: host wall "
        f"{out['graph_wall_ms']:.2f} ms with its one sync, "
        f"{out['graph_event_ms']:.2f} ms by CUDA events, {busy_txt}, pool "
        f"{out['pool'] / 2**30:.2f} GiB; eager: host wall "
        f"{out['eager_wall_ms']:.2f} ms; on {smi}")
    log(f"[moe] device time of the eager burst, {out['total_ms']:.2f} ms in "
        f"{out['launches']} kernels ({out['total_ms'] / k:.2f} ms a step): "
        f"MoE FFN {out['moe_ms']:.2f} ms = share "
        f"{out['moe_ms'] / out['total_ms']:.3f} (expert GEMMs "
        f"{sp['expert GEMMs']:.2f} ms, int8 -> bf16 conversion of the "
        f"stacks {sp['int8 -> bf16 conversion']:.2f} ms, scales "
        f"{sp['scales']:.2f} ms, routing / gating / combine "
        f"{sp['routing, gating, combine']:.2f} ms); attention K2 + K4 "
        f"{out['attn_ms']:.2f} ms; other (attention projections, norms, "
        f"lm_head, sampling) {out['other_ms']:.2f} ms; on {smi}")
    return out


def moe_phase(torch, smi: str, work: str) -> dict:
    """Phase 8h: Mixtral-8x7B at full width and depth in int8 (random
    weights, seed 0), with image chat. In process: the VQ encoder's
    weights (trained at first use on the CPU) and its tokens on the card
    against the plain numpy version; `moe_mlp` against
    `moe_mlp_reference` at one layer (int8 stacks and bf16 stacks); the
    phase path and the ragged path over the same weights, each serving
    the chats of `moe_requests` through the OpenAI pipeline and an
    in-process encode router, launch counts zeroed just before and read
    just after, every dispatch a CUDA-graph run (0 eager); the bare burst
    of `moe_burst_profile`. Then the deployment: the coordinator, a
    `.worker` on a config-only Mixtral dir (random init seed 0, int8,
    `--encode-component encoder`), `.worker --encode-worker
    --image-vocab-offset 30000`, a second encode worker at the default
    offset (component encoder_default, behind a second card this script
    publishes) and `.frontend`: the same chats through HTTP, each a 200
    whose tokens are the in-process phase path's or part at a near-tie
    (MOE_TIE_TOL)."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine import cuda_build, graphs, quant
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine
    from dynamo_tpu_torch.models import llama, mixtral
    from dynamo_tpu_torch.multimodal import encoder as enc
    from dynamo_tpu_torch.multimodal.worker import EncodeWorkerHandler
    from dynamo_tpu_torch.run.main import build_pipeline_for
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import free_port
    from dynamo_tpu_torch.runtime.engine import FnEngine

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[moe] before Mixtral loads: {held / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB free")
    if held > 8 * 2**30:
        raise AssertionError(f"{held / 2**30:.1f} GiB still allocated: phase "
                             f"8's model was not freed")
    ckpt = os.path.join(work, "mixtral-8x7b")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(MIXTRAL_CONFIG, f)
    name = "mixtral-8x7b"

    # the encoder: trained weights (first use trains them on the CPU)
    t0 = time.perf_counter()
    existed = os.path.exists(enc.WEIGHTS_FILE)
    ecfg = enc.ImageEncoderConfig(vocab_offset=IMAGE_OFFSET)
    params = enc.load_trained_encoder(ecfg, dev)
    if params is None:
        raise AssertionError("no trained encoder weights")
    log(f"[moe] VQ encoder weights {'loaded' if existed else 'trained on '
        'the CPU (first use) and loaded'} in {time.perf_counter() - t0:.1f}"
        f" s")
    png = png_rgb(32, 32, seed=3)
    url = "data:image/png;base64," + base64.b64encode(png).decode()
    img = enc.load_image(url, ecfg)
    on_card = enc.encode_image_tokens(params, torch.from_numpy(img).to(dev),
                                      ecfg)
    n = ecfg.image_size // ecfg.patch_size
    x = img.reshape(n, ecfg.patch_size, n, ecfg.patch_size, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(-1, ecfg.patch_dim) \
        .astype("float64")
    x -= x.mean(axis=-1, keepdims=True)
    cb = params["codebook"].double().cpu().numpy()
    d = (cb ** 2).sum(-1)[None] - 2 * (x @ params["proj"].double().cpu()
                                       .numpy()) @ cb.T
    plain = (d.argmin(-1) + IMAGE_OFFSET).tolist()
    if on_card.tolist() != plain or len(plain) != 196:
        raise AssertionError("encode_image_tokens on the card differs from "
                             "its plain numpy version")
    image_ids = on_card.tolist()
    log(f"[moe] encode_image_tokens on the card (fp32) == its plain numpy "
        f"version (fp64) on the 32x32 PNG resized to 224: 196 tokens, "
        f"{len(set(image_ids))} distinct codes, ids "
        f"{min(image_ids)}..{max(image_ids)}")

    # the in-process deployment of the weights the worker will draw
    t0 = time.perf_counter()
    os.environ.pop("DYN_ATTENTION_IMPL", None)
    engine, card = build_torch_engine(
        ckpt, name, num_pages=MOE_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, decode_steps_per_sync=8,
        pipeline_bursts=True, random_init=True, rng_seed=0,
        quantize="int8", device="cuda")
    torch.cuda.synchronize()
    model, cfg = engine.model, engine.model.cfg
    if not isinstance(cfg, mixtral.MoeConfig) or engine.ragged:
        raise AssertionError(f"not an MoE engine on the phase path: {cfg}")
    wbytes = quant.weight_bytes(model)
    stack_bytes = sum(getattr(layer, kk).nbytes for layer in model.layers
                      for kk in ("w_gate", "w_up", "w_down"))
    log(f"[moe] Mixtral-8x7B ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token}, vocab "
        f"{cfg.vocab_size}) random init (seed 0) quantized int8 as drawn, "
        f"+ {MOE_PAGES}-page KV pool, in {time.perf_counter() - t0:.1f} s: "
        f"weight bytes {wbytes} ({wbytes / 1e9:.2f} GB; int8 expert stacks "
        f"{stack_bytes / 1e9:.2f} GB); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved, {torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB free; "
        f"on {smi}")
    if not isinstance(model.layers[0].w_gate, quant.QStack):
        raise AssertionError("the expert stacks are not int8")

    # moe_mlp against the per-token loop: int8 stacks (the served layer 0)
    # and bf16 stacks (one layer drawn in bf16)
    log("[moe] " + moe_mlp_check(torch, mixtral, model.layers[0], cfg, dev,
                                 "int8 stacks (served layer 0)"))
    bf16_layer = mixtral.MoeLayer(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        bf16_layer.router.copy_(torch.randn(bf16_layer.router.shape,
                                            generator=gen, device=dev)
                                / math.sqrt(cfg.hidden_size))
        for key, fan in (("w_gate", cfg.hidden_size),
                         ("w_up", cfg.hidden_size),
                         ("w_down", cfg.intermediate_size)):
            w = getattr(bf16_layer, key)
            for e in range(cfg.num_experts):
                w[e].copy_(torch.randn(w.shape[1:], generator=gen,
                                       device=dev) / math.sqrt(fan))
    log("[moe] " + moe_mlp_check(torch, mixtral, bf16_layer, cfg, dev,
                                 "bf16 stacks (one layer drawn in bf16)"))
    del bf16_layer
    torch.cuda.empty_cache()

    args = type("Args", (), {"tokenizer": "auto", "context_length": None,
                             "max_tokens": MOE_MAX_TOKENS})()
    texts, images, oor = moe_requests(name, url)
    handlers = {off: EncodeWorkerHandler(
        enc.ImageEncoderConfig(vocab_offset=off), device="cuda",
        params=params) for off in (IMAGE_OFFSET, DEFAULT_IMAGE_OFFSET)}

    def serve_in_process(eng, label, must_launch, must_not_launch):
        """The chats through `eng` (closed at the end), launch counts
        zeroed just before and read just after; every dispatch counted
        as a graph run or eager."""
        seen, cached, runs = [], [], {}
        gen_orig, admit = eng.generate, eng._alloc_admission
        graph_run = eng.graphs.run

        def tapped(request, context):
            seen.append(list(request["token_ids"]))
            return gen_orig(request, context)

        def spy(*a):
            got = admit(*a)
            if got is not None:
                cached.append(got[1])
            return got

        def counted(key, fn, inputs):
            runs[key[0]] = runs.get(key[0], 0) + 1
            return graph_run(key, fn, inputs)

        eng.generate, eng._alloc_admission = tapped, spy
        eng.graphs.run = counted
        pipe = build_pipeline_for(card, eng, args, FnEngine(
            handlers[IMAGE_OFFSET].generate))
        pipe_oor = build_pipeline_for(card, eng, args, FnEngine(
            handlers[DEFAULT_IMAGE_OFFSET].generate))

        async def go():
            try:
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                text = await asyncio.gather(*(chat_in_process(pipe, b)
                                              for b in texts))
                wall = time.perf_counter() - t0
                n_text = len(cached)
                image = [await chat_in_process(pipe, b) for b in images]
                image_cached = cached[n_text:]
                far = await chat_in_process(pipe_oor, dict(
                    oor, model=name))
                torch.cuda.synchronize()
                launches = cuda_build.launch_counts()
                # the default-offset prompt with every id past the
                # vocabulary replaced by the last row the gather clamps to
                clamped = [min(t, cfg.vocab_size - 1) for t in seen[-1]]
                toks, tops = [], []
                async for o in eng.generate(
                        {"token_ids": clamped,
                         "sampling": {"temperature": 0.0, "top_logprobs": 8},
                         "stop": {"max_tokens": MOE_MAX_TOKENS}}, Context()):
                    toks.extend(o.get("token_ids", ()))
                    tops.extend(o.get("top_logprobs") or ())
                return (text, wall, image, image_cached, far, launches,
                        (toks, tops), list(eng.ttft_s[:len(texts)]))
            finally:
                await eng.close()

        (text, wall, image, image_cached, far, launches, clamped_run,
         ttft) = asyncio.run(go())
        # the engine's own methods again (no reference cycle keeps it)
        del eng.generate, eng._alloc_admission, eng.graphs.run
        stats = graph_stats(eng)
        graphed = sum(v for e, v in runs.items() if e != "sample_first")
        eager = eng.rounds - graphed
        for kname in must_launch:
            if launches[kname] == 0:
                raise AssertionError(f"{kname} never launched on the MoE "
                                     f"{label} path")
        for kname in must_not_launch:
            if launches[kname] != 0:
                raise AssertionError(f"{kname} launched on the MoE {label} "
                                     f"path")
        if eager != 0 or not stats["replays"] > stats["captures"] > 0:
            raise AssertionError(f"MoE {label} path: {eager} eager "
                                 f"dispatches, graphs {stats}")
        for r in text + image + [far]:
            if r["finish"] not in ("length", "stop") or not r["tokens"]:
                raise AssertionError(f"an MoE {label} chat ended badly: {r}")
        img_prompt = seen[len(texts)]
        run = [t for t in img_prompt if t >= IMAGE_OFFSET]
        if run != image_ids or seen[len(texts) + 1] != img_prompt:
            raise AssertionError(f"MoE {label}: the image chat's prompt "
                                 f"does not carry the image's 196 tokens "
                                 f"(twice)")
        if not image_cached[1] >= image_cached[0] + 192:
            raise AssertionError(f"MoE {label}: the repeated image chat hit "
                                 f"no prefix ({image_cached})")
        far_ids = [t for t in seen[len(texts) + 2]
                   if t >= DEFAULT_IMAGE_OFFSET]
        if len(far_ids) != 196:
            raise AssertionError(f"MoE {label}: the default-offset chat's "
                                 f"prompt holds {len(far_ids)} image ids")
        # raises unless equal or parting at a near-tie
        clamp_parts = stream_partings([(far["tokens"], far["tops"])],
                                      [clamped_run], MOE_TIE_TOL)
        n_out = sum(len(r["tokens"]) for r in text)
        log(f"[moe] {label} path, in process: 6 text chats all in flight, "
            f"{n_out} output tokens in {wall:.2f} s ({n_out / wall:.1f} "
            f"tok/s, TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, the "
            f"graphs' captures inside), then the image chat twice "
            f"({image[0]['prompt_tokens']} prompt tokens, 196 image ids "
            f"{IMAGE_OFFSET}+; the second found {image_cached[1]} prompt "
            f"tokens cached, TTFT {image[0]['ttft_s'] * 1e3:.1f} -> "
            f"{image[1]['ttft_s'] * 1e3:.1f} ms), then the default-offset "
            f"image chat (196 ids >= {DEFAULT_IMAGE_OFFSET} > vocab "
            f"{cfg.vocab_size}: the embedding clamps them to row "
            f"{cfg.vocab_size - 1}, as the JAX package's gather; its "
            f"{len(far['tokens'])} tokens against the clamped prompt's: "
            f"{'identical' if not clamp_parts else clamp_parts}); "
            f"launches {launches}; {eng.rounds} dispatches, {graphed} "
            f"through CUDA graphs ({dict(sorted(runs.items()))}), {eager} "
            f"eager; {graph_summary(eng)}; on {smi}")
        return {"text": text, "image": image, "far": far, "wall": wall,
                "ttft": ttft, "launches": launches, "graphs": stats}

    phase = serve_in_process(
        engine, "phase", ("paged_kv_write", "paged_kv_write_pages",
                          "paged_attention_decode", "ragged_paged_attention"),
        ("w8a8_matmul", "int4_matmul"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ragged_eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=MOE_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, attention_impl="ragged", device="cuda"),
        model=model)
    ragged_run = serve_in_process(
        ragged_eng, "ragged", ("ragged_paged_attention", "paged_kv_write"),
        ("paged_kv_write_pages", "paged_attention_decode", "w8a8_matmul",
         "int4_matmul"))
    del ragged_eng
    gc.collect()
    torch.cuda.empty_cache()

    def streams(run):
        return [(r["tokens"], r["tops"]) for r in
                run["text"] + run["image"] + [run["far"]]]

    parts = compare_streams(streams(phase), streams(ragged_run),
                            "moe phase vs ragged", MOE_TIE_TOL)
    log(f"[moe] phase vs ragged path (bf16 activations, int8 experts): "
        f"{9 - len(parts)} of 9 streams token-identical, {len(parts)} "
        f"parted at near-ties (MOE_TIE_TOL {MOE_TIE_TOL})")
    profile = moe_burst_profile(torch, llama, mixtral, graphs, model, dev,
                                smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the deployment: worker, two encode workers, frontend
    services = []
    try:
        coord = Service(work, "coordinator", "--port", str(free_port()))
        services.append(coord)
        store = coord.wait_line("COORDINATOR_READY", 120)
        t0 = time.perf_counter()
        worker = Service(work, "worker", "--model", ckpt, "--random-init",
                         "--quantize", "int8", "--served-model-name", name,
                         "--router-mode", "round_robin", "--num-pages",
                         str(MOE_PAGES), "--max-batch-size", "8",
                         "--prefill-chunk", "512", "--store", store,
                         "--device", "cuda", "--encode-component", "encoder")
        services.append(worker)
        encoder = Service(work, "worker", "--encode-worker",
                          "--image-vocab-offset", str(IMAGE_OFFSET),
                          "--store", store, label="encoder")
        services.append(encoder)
        encoder_default = Service(work, "worker", "--encode-worker",
                                  "--component", "encoder_default",
                                  "--store", store, label="encoder_default")
        services.append(encoder_default)
        port = free_port()
        frontend = Service(work, "frontend", "--store", store, "--host",
                           "127.0.0.1", "--port", str(port),
                           "--router-mode", "round_robin")
        services.append(frontend)
        frontend.wait_line("FRONTEND_READY", 120)
        encoder.wait_line("WORKER_READY", 300)
        encoder_default.wait_line("WORKER_READY", 300)
        ready = worker.wait_line("WORKER_READY", 900)
        built = [ln for ln in worker.stderr_tail(100000).splitlines()
                 if "engine built in" in ln]
        log(f"[moe] worker {ready} ready {time.perf_counter() - t0:.1f} s "
            f"after its start ({built[-1].split(': ', 1)[-1] if built else ''}"
            f"); with it up: {torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB "
            f"free on the card")
        streams_http = asyncio.run(moe_http(store, port, name, texts,
                                            images, oor))
        for p in services:
            if p.proc.poll() is not None:
                raise AssertionError(f"{p.name} exited: {p.stderr_tail()}")
        scrapes = asyncio.run(worker_scrape(store))
        wk = next(t for t in scrapes.values()
                  if "dynamo_engine_cuda_graphs" in t)
    finally:
        for p in reversed(services):
            p.stop()
    text_h, image_h, far_h, wall_h = streams_http
    got = [(s["tokens"], s["tops"]) for s in text_h + image_h + [far_h]]
    parts_h = compare_streams(streams(phase), got, "moe http", MOE_TIE_TOL)
    g = worker_graphs(wk)
    wl = {k.split('"')[1]: int(v) for k, v in series_values(
        wk, "dynamo_engine_kernel_launches").items()}
    if not g["replays"] > g["captures"] > 0:
        raise AssertionError(f"the Mixtral worker replayed no graph: {g}")
    if not all(wl.get(kk, 0) > 0 for kk in (
            "paged_kv_write", "paged_kv_write_pages",
            "paged_attention_decode", "ragged_paged_attention")) \
            or wl.get("w8a8_matmul", 0) or wl.get("int4_matmul", 0):
        raise AssertionError(f"the Mixtral worker's launches: {wl}")
    rows = [{"ttft_s": s["ttft_s"], "elapsed_s": s["elapsed_s"],
             "n": len(s["tokens"])} for s in text_h]
    log(f"[moe] through HTTP (coordinator, Mixtral worker, two encode "
        f"workers, frontend; 5 processes): 9 chats, all 200 with "
        f"well-formed SSE; {9 - len(parts_h)} token-identical with the "
        f"in-process phase path, {len(parts_h)} parted at near-ties; the "
        f"image chat's prompt {image_h[0]['prompt_tokens']} tokens both "
        f"times, TTFT {image_h[0]['ttft_s'] * 1e3:.1f} -> "
        f"{image_h[1]['ttft_s'] * 1e3:.1f} ms (prefix hit); text chats: "
        f"{latency_summary(rows, wall_h)}; the worker's graphs: "
        f"{g['captures']:.0f} captures, {g['replays']:.0f} replays, pool "
        f"{g['pool_bytes'] / 2**30:.2f} GiB; its launches {wl}; on {smi}")
    return {"phase": phase, "ragged": ragged_run, "profile": profile,
            "weight_bytes": wbytes}


async def moe_http(store: str, port: int, name: str, texts: list,
                   images: list, oor: dict):
    """Phase 8h's chats through the frontend: a second card (the worker's,
    under another name, its image parts sent to the default-offset encode
    workers) published from this script's runtime for the default-offset
    chat; the text chats all in flight, then the image chats one after
    another."""
    from dynamo_tpu_torch.llm.model_card import (
        MDC_PREFIX,
        ModelDeploymentCard,
        register_llm,
    )
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    rt = await DistributedRuntime.create(RuntimeConfig(store_url=store))
    try:
        end = time.perf_counter() + 60
        card = None
        while card is None:
            for kv in await rt.store.get_prefix(MDC_PREFIX):
                c = ModelDeploymentCard.from_json(kv.value)
                if c.name == name:
                    card = c
            if card is None:
                if time.perf_counter() > end:
                    raise AssertionError("the worker's card never appeared")
                await asyncio.sleep(0.2)
        if card.encode_component != "encoder":
            raise AssertionError(f"the worker's card: {card}")
        card.name = oor["model"]
        card.encode_component = "encoder_default"
        await register_llm(rt, card)
        for model in (name, oor["model"]):
            while f'"{model}"'.encode() not in await asyncio.to_thread(
                    _http_get, port, "/v1/models"):
                if time.perf_counter() > end:
                    raise AssertionError(f"the frontend never listed {model}")
                await asyncio.sleep(0.2)
        t0 = time.perf_counter()
        text = await asyncio.gather(*(asyncio.to_thread(
            http_chat_stream, port, b) for b in texts))
        wall = max(s["t0"] + s["elapsed_s"] for s in text) - t0
        image = [await asyncio.to_thread(http_chat_stream, port, b)
                 for b in images]
        far = await asyncio.to_thread(http_chat_stream, port, oor)
        return text, image, far, wall
    finally:
        await rt.close()


# -- phase 8i: the engine's flight recorders ---------------------------------

# seeded greedy chats of phase 8i (token counts), served by an unarmed and
# an armed engine of each path
RECORDER_PROMPT_LENS = (24, 150, 300, 700)
RECORDER_MAX_TOKENS = 16
# chat texts of phase 8i's HTTP part (bytes, byte tokenizer)
RECORDER_TEXTS = (60, 260, 610)
# phase 8k: the admission and control planes on a small pool (96 usable
# pages of 16, ~192 MiB at 8B bf16: wave 1's 16 prompts hold ~10 pages
# each, so repeating them evicts)
ADMISSION_PAGES = 97
ADMISSION_TEXT_BYTES = 120
ADMISSION_MAX_TOKENS = 16
ADMISSION_WAVE = 16                 # 8 bronze, then 8 gold
ADMISSION_REPEATS = 3               # wave 3's most repeats of wave 1
# prompts of the 384-token prefill bucket (256 < n <= 384) and the rung
# proposed for them (page-aligned, covering all of them)
RUNG_PROMPT_LENS = tuple(range(257, 288, 4))
RUNG = 288
# the OOM child: the caching allocator's cap above what it holds once the
# 2-layer engine has served a short chat; a 512-token prefill's
# activations alone need more (a (512, 14336) bf16 tensor is 14 MiB)
OOM_MARGIN = 8 << 20
OOM_CHILD = r'''
import asyncio, os, sys
import torch
sys.path.insert(0, {root!r})
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.runtime.context import Context

dev = torch.device("cuda", torch.cuda.current_device())
cfg = llama.LlamaConfig.llama3_8b(num_layers=2)
eng = TorchEngine(TorchEngineConfig(model=cfg, num_pages=512,
                                    max_batch_size=8, device="cuda"))

async def one(prompt, n):
    async for o in eng.generate({{"token_ids": prompt,
                                 "sampling": {{"temperature": 0.0}},
                                 "stop": {{"max_tokens": n}}}}, Context()):
        if o.get("finish_reason") == "error":
            raise SystemExit(f"request failed: {{o}}")

async def main():
    await one(list(range(1, 17)), 4)          # fits: the step tail
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info(dev)[1]
    cap = torch.cuda.memory_reserved(dev) + {margin}
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    print("CHILD_CAPPED", torch.cuda.memory_allocated(dev), cap, total,
          flush=True)
    await one(list(range(1, 2001)), 4)        # its first prefill: OOM

asyncio.run(main())
print("CHILD_SURVIVED", flush=True)
'''


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set (None: unset) for the block's duration."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def entry_rows(rec, wall: float) -> list:
    """Per entry of a step recorder's ring: (entry, dispatches, good, work,
    padded %, host s, gap s / wall, captures, capture host s)."""
    rows: dict = {}
    for r in rec.snapshot():
        e = rows.setdefault(r["entry"], [0, 0, 0, 0.0, 0.0, 0, 0.0])
        e[0] += 1
        e[1] += r["good_tokens"]
        e[2] += r["work_tokens"]
        e[3] += r["host_s"]
        e[4] += r["gap_s"] or 0.0
        if r["compiled"]:
            e[5] += 1
            e[6] += r["host_s"]
    return [(name, n, g, w, 100.0 * (w - g) / w if w else 0.0, h,
             gap / wall if wall else 0.0, nc, hc)
            for name, (n, g, w, h, gap, nc, hc) in sorted(rows.items())]


HAND_WRITTEN = ("paged_attention_core", "paged_decode_kernel",
                "decode_combine_splits", "combine_splits_kernel",
                "ragged_fp32_kernel", "paged_kv_write_kernel",
                "paged_kv_write_pages_kernel", "paged_kv_gather_kernel",
                "w8a8_gemm", "int4_gemm", "quantize_rows_kernel")


def trace_kernels(path: str) -> tuple[dict, int, int]:
    """A torch.profiler Chrome trace's device kernels: ({kernel class:
    launches} of the hand-written kernels, all kernel events,
    cudaGraphLaunch calls)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_class: dict = {}
    kernels_n = launches = 0
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "kernel":
            kernels_n += 1
            if any(h in name for h in HAND_WRITTEN):
                cls = ("KV gather" if "paged_kv_gather" in name
                       else kernel_class(name))
                by_class[cls] = by_class.get(cls, 0) + 1
        elif name.startswith("cudaGraphLaunch"):
            launches += 1
    return by_class, kernels_n, launches


def recorders_phase(torch, smi: str, work: str, card, model) -> dict:
    """Phase 8i: the step recorder and the memory ledger at Llama-3-8B (see
    the module docstring). Returns the numbers PERF.md keeps."""
    import dataclasses

    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.engine.memory import format_oom_attribution
    from dynamo_tpu_torch.engine.watchdog import DispatchWatchdog
    from dynamo_tpu_torch.llm.entrypoint import (
        serve_engine,
        start_frontend,
        wire_engine_events,
    )
    from dynamo_tpu_torch.models.loader import params_footprint
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    cfg = model.cfg
    rng = random.Random(17)
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in RECORDER_PROMPT_LENS]
    out: dict = {}

    async def chats(eng):
        async def one(p):
            toks = []
            async for o in eng.generate(
                    {"token_ids": p, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": RECORDER_MAX_TOKENS}},
                    Context()):
                if o.get("finish_reason") == "error":
                    raise AssertionError(f"8i request failed: {o}")
                toks.extend(o.get("token_ids", ()))
            return toks
        return list(await asyncio.gather(*(one(p) for p in prompts)))

    async def http_part(eng):
        """The in-process deployment over the armed phase engine: the
        /debug routes, a torch.profiler window while chats stream (and
        one eager KV gather runs), the dispatch watchdog throughout."""
        rt = await DistributedRuntime.create(RuntimeConfig(store_url="memory"))
        c = dataclasses.replace(card, namespace="dynamo", component="run",
                                router_mode="kv")
        eng.attach_sinks(*wire_engine_events(rt, c))
        wd = DispatchWatchdog(eng, 60.0, instance="8i")
        handle = fe = None
        try:
            handle = await serve_engine(rt, eng, c,
                                        instance_id=eng.config.worker_id)
            fe = await start_frontend(rt, port=0)
            for _ in range(500):
                if c.name in fe.manager.model_names():
                    break
                await asyncio.sleep(0.01)
            port = fe.http.port
            wd.start()

            def body(n):
                text = "".join(chr(97 + (i * 7 + n) % 26) for i in range(n))
                return {"model": c.name, "stream": True,
                        "max_tokens": RECORDER_MAX_TOKENS,
                        "temperature": 0.0, "logprobs": True,
                        "top_logprobs": 8,
                        "return_tokens_as_token_ids": True,
                        "messages": [{"role": "user", "content": text}]}

            async def sequential():
                return [await asyncio.to_thread(http_chat_stream, port,
                                                body(n))
                        for n in RECORDER_TEXTS]

            # one pass captures the chats' shapes; the window's pass, on a
            # cleared prefix cache, replays them
            warm = await sequential()
            statuses = {}
            for path in ("/debug", "/debug/profile",
                         "/debug/profile?format=chrome", "/debug/memory",
                         "/debug/kv", "/debug/router"):
                st, raw = await asyncio.to_thread(_http_status, port, path)
                statuses[path] = (st, len(raw))
                if st != 200:
                    raise AssertionError(f"8i GET {path}: HTTP {st} "
                                         f"{raw[:300]!r}")
            idx = json.loads(
                (await asyncio.to_thread(_http_status, port, "/debug"))[1])
            eng.clear_kv_blocks()
            captures0 = eng.graphs.captures

            async def traffic():
                await asyncio.sleep(0.2)
                got = await sequential()
                await eng.read_kv_pages_device([1, 2, 3])   # eager K gather
                return got

            t_cap = time.perf_counter()
            cap_raw, during = await asyncio.gather(
                asyncio.to_thread(_http_status, port,
                                  "/debug/profile?capture_s=2"),
                traffic())
            cap_wall = time.perf_counter() - t_cap
            if cap_raw[0] != 200:
                raise AssertionError(f"8i capture: HTTP {cap_raw[0]}")
            capture = json.loads(cap_raw[1])["capture"]
            if "error" in capture:
                raise AssertionError(f"8i capture failed: {capture}")
            new_captures = eng.graphs.captures - captures0
            if [r["tokens"] for r in during] != [r["tokens"] for r in warm]:
                raise AssertionError("8i: the window's chats differ from "
                                     "the same chats before it")
            return {"statuses": statuses, "index": sorted(idx["surfaces"]),
                    "capture": capture, "cap_wall": cap_wall,
                    "new_captures": new_captures,
                    "longest_stall": wd.longest_stall_s,
                    "tripped": wd.tripped, "chats": len(warm) + len(during)}
        finally:
            wd.stop()
            if fe is not None:
                await fe.stop()
            if handle is not None:
                await handle.stop()
            await rt.close()

    def run(impl: str, armed: bool) -> dict:
        on = "1" if armed else None
        with env_set(DYN_STEP_PROFILE=on, DYN_MEM_LEDGER=on):
            eng = TorchEngine(TorchEngineConfig(
                model=cfg, num_pages=2048, max_batch_size=8,
                attention_impl=impl, device="cuda"), model=model)
        if (eng.step_recorder is not None) != armed or \
                (eng.memory_ledger is not None) != armed:
            raise AssertionError(f"8i: the {impl} engine's recorders are "
                                 f"not {'armed' if armed else 'off'}")

        async def go():
            try:
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                streams = await chats(eng)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                res = {"streams": streams, "wall": wall,
                       "launches": cuda_build.launch_counts(),
                       "captures": eng.graphs.captures,
                       "replays": eng.graphs.replays,
                       "rounds": eng.rounds,
                       "pool_bytes": eng.graphs.pool_bytes()}
                if armed:
                    rec, led = eng.step_recorder, eng.memory_ledger
                    res["rows"] = entry_rows(rec, wall)
                    res["records"] = rec.snapshot()
                    res["summary"] = rec.summary()
                    res["snap"] = led.poll()
                    res["ws"] = led.summary()["workspace"]
                    res["kv_bytes"] = sum(
                        t.numel() * t.element_size()
                        for t in (*eng.k_cache, *eng.v_cache))
                    if impl == "phase":
                        res["http"] = await http_part(eng)
                return res
            finally:
                await eng.close()

        # armed, the request tracer and the audit bus too (DYN_TRACE and
        # DYN_AUDIT, read at their first use: the process tracer is made
        # afresh from the environment)
        trace = os.path.join(work, f"8i_trace_{impl}.jsonl")
        audit = os.path.join(work, f"8i_audit_{impl}.jsonl")
        tracing.set_tracer(None)
        try:
            with env_set(DYN_TRACE=on, DYN_TRACE_PATH=trace, DYN_AUDIT=on,
                         DYN_AUDIT_SINKS="jsonl" if armed else None,
                         DYN_AUDIT_PATH=audit):
                res = asyncio.run(go())
                tr = tracing.tracer()
                asyncio.run(tr.close())
            if tr.enabled != armed:
                raise AssertionError(f"8i {impl}: the tracer is not "
                                     f"{'armed' if armed else 'off'}")
            if armed:
                res["tracer"] = (tr.exported, tr.dropped)
                res["spans"] = read_spans(trace)
                res["audit"] = read_spans(audit)
            return res
        finally:
            tracing.set_tracer(None)
            # the deployment's runtime and the engine reference each other
            del eng
            gc.collect()
            torch.cuda.empty_cache()

    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if params_footprint(model) != weights:
        raise AssertionError(f"8i: params_footprint {params_footprint(model)}"
                             f" != the parameters' {weights} bytes")
    must = {"phase": ("ragged_paged_attention", "paged_kv_write",
                      "paged_kv_write_pages", "paged_attention_decode"),
            "ragged": ("ragged_paged_attention", "paged_kv_write")}
    for impl in ("phase", "ragged"):
        t0 = time.perf_counter()
        plain = run(impl, armed=False)
        armed = run(impl, armed=True)
        if armed["streams"] != plain["streams"] or any(
                len(s) != RECORDER_MAX_TOKENS for s in armed["streams"]):
            raise AssertionError(f"8i {impl}: armed streams differ from "
                                 f"unarmed ones")
        if (armed["captures"], armed["replays"], armed["launches"],
                armed["rounds"]) != (plain["captures"], plain["replays"],
                                     plain["launches"], plain["rounds"]):
            raise AssertionError(
                f"8i {impl}: armed dispatches differ: captures/replays/"
                f"rounds {armed['captures']}/{armed['replays']}/"
                f"{armed['rounds']} vs {plain['captures']}/"
                f"{plain['replays']}/{plain['rounds']}; launches "
                f"{armed['launches']} vs {plain['launches']}")
        for k in must[impl]:
            if armed["launches"][k] == 0:
                raise AssertionError(f"8i {impl}: {k} never launched armed")
        # every request of the armed run one trace: the chats, and on the
        # phase path the deployment's chats (one audit record each)
        roots = [r for r in armed["spans"] if r["name"] == "engine.request"]
        n_req = len(prompts) + (armed["http"]["chats"] if impl == "phase"
                                else 0)
        n_audit = armed["http"]["chats"] if impl == "phase" else 0
        complete = sum(1 for root in roots if root["status"]["code"] == "OK"
                       and {r["name"] for r in armed["spans"]
                            if r["traceId"] == root["traceId"]}
                       >= set(ENGINE_STAGES))
        if complete != n_req or len(roots) != n_req or \
                armed["tracer"][1] or \
                armed["tracer"][0] != len(armed["spans"]) or \
                len(armed["audit"]) != n_audit:
            raise AssertionError(
                f"8i {impl}: {len(roots)} engine.request roots "
                f"({complete} complete) for {n_req} requests; tracer "
                f"exported/dropped {armed['tracer']} for "
                f"{len(armed['spans'])} spans; {len(armed['audit'])} audit "
                f"records for {n_audit} chats")
        log(f"[recorders] {impl} path armed with DYN_TRACE and DYN_AUDIT "
            f"too: {len(roots)} requests, each one trace with its "
            f"queue_wait / prefill.chunk / prefill / decode spans "
            f"({len(armed['spans'])} spans, 0 dropped); "
            f"{len(armed['audit'])} audit records; streams, captures, "
            f"replays and launches equal to the unarmed run's; on {smi}")
        graphed = [r for r in armed["records"] if r["entry"] != "burst_sync"]
        if len(graphed) != armed["replays"] or sum(
                r["compiled"] for r in graphed) != armed["captures"]:
            raise AssertionError(
                f"8i {impl}: {len(graphed)} recorded dispatches "
                f"({sum(r['compiled'] for r in graphed)} captures) for "
                f"{armed['replays']} graph runs ({armed['captures']} "
                f"captures): a dispatch was not a graph run")
        snap = armed["snap"]
        if snap["classes"]["weights"] != weights or \
                snap["classes"]["kv_pool"] != armed["kv_bytes"]:
            raise AssertionError(f"8i {impl}: ledger classes "
                                 f"{snap['classes']} vs weights {weights}, "
                                 f"KV {armed['kv_bytes']}")
        s = armed["summary"]
        log(f"[recorders] {impl} path: {len(prompts)} seeded greedy chats "
            f"({RECORDER_PROMPT_LENS} tokens, {RECORDER_MAX_TOKENS} out) "
            f"armed == unarmed token for token; {armed['replays']} graph "
            f"runs ({armed['captures']} captures) both, every recorded "
            f"dispatch a graph run; launches equal "
            f"{ {k: armed['launches'][k] for k in must[impl]} }; wall "
            f"{plain['wall']:.3f} s unarmed, {armed['wall']:.3f} s armed "
            f"(first batch, captures inside); goodput "
            f"{s['totals']['good_tokens']} of {s['totals']['work_tokens']} "
            f"work tokens ({s['totals']['padded_pct']:.2f}% padded); on "
            f"{smi}")
        for (name, n, g, w, pad, host, gap, nc, hc) in armed["rows"]:
            log(f"[recorders] {impl} {name}: {n} dispatches, good {g} / "
                f"work {w} tokens ({pad:.2f}% padded), host "
                f"{host * 1e3:.3f} ms in all, gaps {100 * gap:.2f}% of the "
                f"wall; {nc} captures in {hc * 1e3:.3f} ms; on {smi}")
        dev_s = snap["device"]
        in_use = dev_s["bytes_in_use"]
        top = armed["ws"]["shapes"][:8]
        per_entry: dict = {}
        for sh in armed["ws"]["shapes"]:
            per_entry[sh["entry"]] = per_entry.get(sh["entry"], 0) + \
                sh["bytes"]
        log(f"[recorders] {impl} memory: in use {in_use} B (allocated), "
            f"limit {dev_s['bytes_limit']} B (free + reserved), peak "
            f"{dev_s['peak_bytes_in_use']} B, reserved "
            f"{dev_s['reserved_bytes']} B, total {dev_s['total_bytes']} B; "
            f"weights {snap['classes']['weights']} B == params_footprint == "
            f"the parameters' bytes, kv_pool {snap['classes']['kv_pool']} B "
            f"== the K/V caches' bytes; workspace "
            f"{armed['ws']['total_bytes']} B over "
            f"{len(armed['ws']['shapes'])} (entry, shape) keys, by entry "
            f"{per_entry}; graph pool {armed['pool_bytes']} B; residual "
            f"{snap['unattributed_bytes']} B "
            f"({100.0 * snap['unattributed_bytes'] / in_use:.2f}% of in "
            f"use); headroom {snap['headroom_bytes']} B; on {smi}")
        log(f"[recorders] {impl} workspace, largest first: "
            + "; ".join(f"{sh['entry']} {sh['shape']} {sh['bytes']} B"
                        for sh in top))
        out[impl] = {"rows": armed["rows"], "snap": snap,
                     "ws": armed["ws"], "walls": (plain["wall"],
                                                  armed["wall"]),
                     "pool_bytes": armed["pool_bytes"]}
        if impl == "phase":
            h = armed["http"]
            cap = h["capture"]
            by_class, n_kernels, graph_launches = trace_kernels(cap["trace"])
            replayed = {k: v for k, v in by_class.items()
                        if k != "KV gather"}
            log(f"[recorders] /debug over HTTP (in process, run in=http's "
                f"wiring): {h['statuses']} (status, body bytes); index "
                f"{h['index']}; {h['chats']} streamed chats")
            log(f"[recorders] /debug/profile?capture_s=2 while "
                f"{len(RECORDER_TEXTS)} chats streamed and one eager KV "
                f"gather ran: {cap['bytes']} B Chrome trace, "
                f"{cap['captured_s']} s window ({h['cap_wall']:.3f} s "
                f"request wall; the profiler's start {cap['start_s']:.3f} s "
                f"and stop {cap['stop_s']:.3f} s with the engine held), "
                f"activities {cap['activities']}; "
                f"{n_kernels} device kernel events, {graph_launches} "
                f"cudaGraphLaunch calls, hand-written kernels by class "
                f"{by_class}; {h['new_captures']} graph captures inside the "
                f"window; on {smi}")
            if "KV gather" not in by_class:
                raise AssertionError("8i: the capture names no hand-written "
                                     f"kernel of the eager gather: {by_class}")
            if not replayed and not graph_launches:
                raise AssertionError("8i: the capture shows neither the "
                                     "replays' kernels nor their launches")
            log(f"[recorders] the profiler "
                + ("sees the kernels inside graph replays"
                   if replayed else "shows graph replays only as "
                   "cudaGraphLaunch (their kernels hidden)")
                + f"; on {smi}")
            trips = 0 if h["tripped"] is None else 1
            log(f"[recorders] dispatch watchdog (stall 60 s, reads the "
                f"armed recorder's last_dispatch_pc) over the HTTP part: "
                f"longest stall with work pending {h['longest_stall']:.3f} s, "
                f"{trips} trips; on {smi}")
            if trips:
                raise AssertionError(f"8i: the watchdog tripped: "
                                     f"{h['tripped']}")
            out["http"] = {"kernels": by_class, "graph_launches":
                           graph_launches, "bytes": cap["bytes"],
                           "longest_stall": h["longest_stall"]}
        log(f"[recorders] {impl} path pair in "
            f"{time.perf_counter() - t0:.1f} s")

    # a real OOM in a child process --------------------------------------
    t0 = time.perf_counter()
    crash_dir = os.path.join(work, "oom")
    env = dict(os.environ, DYN_MEM_LEDGER="1", DYN_STEP_PROFILE="1",
               DYN_OOM_EXIT="1", DYN_MEM_CRASH_DIR=crash_dir)
    env.pop("DYN_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         OOM_CHILD.format(root=ROOT, margin=OOM_MARGIN)],
        env=env, capture_output=True, text=True, timeout=300)
    files = sorted(os.listdir(crash_dir)) if os.path.isdir(crash_dir) \
        else []
    if proc.returncode != 45 or len(files) != 1:
        raise AssertionError(f"8i OOM child: rc {proc.returncode}, crash "
                             f"files {files}; stdout {proc.stdout[-1500:]}; "
                             f"stderr {proc.stderr[-3000:]}")
    with open(os.path.join(crash_dir, files[0])) as f:
        report = json.load(f)
    trig = report["triggering"] or {}
    if (trig.get("entry"), trig.get("shape")) != ("prefill", "1x512x1") \
            or not report["step_tail"] or not report["last_snapshot"]:
        raise AssertionError(f"8i OOM child: crash file names "
                             f"{trig}, step tail {len(report['step_tail'])}")
    capped = next(line for line in proc.stdout.splitlines()
                  if line.startswith("CHILD_CAPPED"))
    last = report["last_snapshot"]
    log(f"[recorders] OOM child (Llama-3-8B width, 2 layers, allocator "
        f"capped {OOM_MARGIN} B above its reservation: {capped}): exit "
        f"{proc.returncode}, crash file {files[0]} naming "
        f"{trig['entry']} {trig['shape']} (compiled {trig['compiled']}); "
        f"error {report['error'][:160]!r}; last snapshot classes "
        f"{last['classes']}, device {last['device']}, residual "
        f"{last['unattributed_bytes']} B; step tail "
        f"{[(r['entry'], r['shape']) for r in report['step_tail']]}; "
        f"attribution: {format_oom_attribution(report)}; child in "
        f"{time.perf_counter() - t0:.1f} s; on {smi}")
    out["oom"] = {"triggering": trig,
                  "attribution": format_oom_attribution(report)}
    return out

# -- the admission and control planes (phase 8k) ----------------------------

def http_chat_refused(port: int, body: dict, headers: dict) -> tuple:
    """A chat the frontend should refuse: (status, Retry-After, the
    OpenAI error type)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json", **headers})
        r = conn.getresponse()
        raw = r.read()
        retry = r.getheader("Retry-After")
    finally:
        conn.close()
    err = json.loads(raw).get("error", {}) if raw[:1] == b"{" else {}
    return r.status, retry, err.get("type")


class AdmissionLog(list):
    """An engine's `_running` list that logs each admission: (tenant,
    prompt tokens, queue wait s, when)."""

    def __init__(self) -> None:
        super().__init__()
        self.log: list = []

    def append(self, seq) -> None:
        now = time.perf_counter()
        self.log.append((seq.tenant, len(seq.prompt), now - seq.t_enqueue,
                         now))
        super().append(seq)


def admission_phase(torch, smi: str, card, model) -> dict:
    """Phase 8k: the tenancy, serving-class and flight-control planes at
    Llama-3-8B (see the module docstring). Returns the numbers PERF.md
    keeps."""
    import dataclasses

    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.entrypoint import (
        serve_engine,
        start_frontend,
        wire_engine_events,
    )
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols_openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.serving_classes import BROWNOUT_EVENTS_SUBJECT
    from dynamo_tpu_torch.tenancy import estimate_request_tokens

    cfg = model.cfg
    P = cfg.page_size
    c = dataclasses.replace(card, namespace="dynamo", component="run",
                            router_mode="kv")
    pre = OpenAIPreprocessor(
        make_tokenizer(c.tokenizer_kind, c.tokenizer_path), c.name)
    texts = ["".join(chr(97 + (i * 7 + 3 * n) % 26)
                     for i in range(ADMISSION_TEXT_BYTES))
             for n in range(ADMISSION_WAVE)]

    def body(text: str, max_tokens: int = ADMISSION_MAX_TOKENS) -> dict:
        return {"model": c.name, "stream": True, "max_tokens": max_tokens,
                **GREEDY_FIELDS,
                "messages": [{"role": "user", "content": text}]}

    def engine_request(b: dict) -> dict:
        """What the frontend's preprocessor hands the engine for `b`."""
        return pre.preprocess_chat(ChatCompletionRequest.from_dict(
            b)).to_dict()

    # wave 1's chats, then the brownout's standard chat capped to 32
    want_bodies = [body(t) for t in texts] + [body(texts[1], 32)]
    prompts = [engine_request(b) for b in want_bodies]
    plen = len(prompts[0]["token_ids"])
    # two requests' pages at their largest: prompt, the tokens out and
    # two bursts of page growth ahead of the position
    budget = 2 * -(-(plen + ADMISSION_MAX_TOKENS + 16) // P)
    capped_tokens = estimate_request_tokens(body(texts[0]))
    tenancy = {"tenants": [
        {"name": "gold", "weight": 3.0},
        {"name": "bronze", "weight": 1.0, "kv_block_budget": budget},
        {"name": "capped", "token_rate": 1.0,
         "token_burst": float(capped_tokens)}]}
    classes = {"brownout_hold_s": 1.0, "brownout_recover_s": 3.0}
    out: dict = {"budget": budget, "prompt_tokens": plen}

    def make_engine():
        return TorchEngine(TorchEngineConfig(
            model=cfg, num_pages=ADMISSION_PAGES, max_batch_size=8,
            attention_impl="phase", device="cuda"), model=model)

    async def collect(eng, req: dict) -> tuple:
        toks, tops = [], []
        async for o in eng.generate(req, Context()):
            if o.get("finish_reason") == "error":
                raise AssertionError(f"8k request failed: {o}")
            toks.extend(o.get("token_ids", ()))
            tops.extend(o.get("top_logprobs") or ())
        return toks, tops

    # the unarmed reference ------------------------------------------------
    async def unarmed() -> list:
        eng = make_engine()
        try:
            return list(await asyncio.gather(
                *(collect(eng, r) for r in prompts)))
        finally:
            await eng.close()

    t0 = time.perf_counter()
    want = asyncio.run(unarmed())
    out["unarmed_wall"] = time.perf_counter() - t0
    log(f"[admission] unarmed phase engine ({ADMISSION_PAGES} pages, batch "
        f"8): {len(want)} chats of {plen} prompt tokens in "
        f"{out['unarmed_wall']:.1f} s (first batch, captures inside); on "
        f"{smi}")

    async def armed() -> dict:
        rt = await DistributedRuntime.create(RuntimeConfig(
            store_url="memory", slo_check_interval=3600.0))
        eng = make_engine()
        if eng.fair is None or eng.classes is None or \
                eng.step_recorder is None or eng.kv_lifecycle is None:
            raise AssertionError("8k: the engine's planes are not armed")
        eng.attach_sinks(*wire_engine_events(rt, c))
        eng._running = adm = AdmissionLog()
        clients = concurrent.futures.ThreadPoolExecutor(2 * ADMISSION_WAVE)
        handle = fe = None
        res: dict = {}
        try:
            handle = await serve_engine(rt, eng, c,
                                        instance_id=eng.config.worker_id)
            fe = await start_frontend(rt, port=0)
            for _ in range(500):
                if c.name in fe.manager.model_names():
                    break
                await asyncio.sleep(0.01)
            svc, plane, bo = fe.http, fe.control, fe.http.brownout
            if svc.quota is None or plane is None or bo is None or \
                    sorted(x.name for x in plane.controllers) != [
                        "brownout", "bucket", "kvbm", "router"]:
                raise AssertionError("8k: the frontend's planes are not "
                                     "armed")
            port = svc.port

            def get(path: str) -> dict:
                st, raw = _http_status(port, path)
                if st != 200:
                    raise AssertionError(f"8k GET {path}: HTTP {st} "
                                         f"{raw[:300]!r}")
                return json.loads(raw)

            async def chat(i: int, tenant=None, cls=None, max_tokens=None):
                hdrs = {}
                if tenant:
                    hdrs["x-dyn-tenant"] = tenant
                if cls:
                    hdrs["x-dyn-class"] = cls
                b = body(texts[i], max_tokens or ADMISSION_MAX_TOKENS)
                # a client thread each: the default executor has fewer
                # threads than a wave has chats on an 8-core host
                return await asyncio.get_running_loop().run_in_executor(
                    clients, http_chat_stream, port, b, hdrs)

            cuda_build.reset_launch_counts()

            # wave 1: fair share -------------------------------------------
            t_w = time.perf_counter()
            peak = {"bronze": 0, "samples": 0}

            async def poll_bronze():
                while True:
                    if any(s.tenant == "gold" for s in eng._running):
                        peak["bronze"] = max(peak["bronze"],
                                             eng._tenant_pages("bronze"))
                        peak["samples"] += 1
                    await asyncio.sleep(0.005)

            async def queued(n: int):
                for _ in range(3000):
                    if len(eng._waiting) + len(eng._running) >= n:
                        return
                    await asyncio.sleep(0.01)
                raise AssertionError(f"8k: {n} requests never queued")

            poller = asyncio.ensure_future(poll_bronze())
            await eng._device_lock.acquire()
            try:
                bronze = [asyncio.ensure_future(chat(i, "bronze"))
                          for i in range(8)]
                await queued(8)
                gold = [asyncio.ensure_future(chat(i, "gold"))
                        for i in range(8, 16)]
                await queued(16)
            finally:
                eng._device_lock.release()
            wave1 = list(await asyncio.gather(*bronze, *gold))
            poller.cancel()
            res["wave1_wall"] = time.perf_counter() - t_w
            res["order"] = [t for t, *_ in adm.log[:ADMISSION_WAVE]]
            res["bronze_peak"] = dict(peak)
            # capped: one admitted, the next refused before any engine work
            capped1 = await chat(0, "capped")
            arrivals = eng._arrivals
            res["capped"] = await asyncio.to_thread(
                http_chat_refused, port, body(texts[0]),
                {"x-dyn-tenant": "capped"})
            res["capped_arrivals"] = (arrivals, eng._arrivals)
            res["wave1"] = wave1 + [capped1]

            # wave 2: the brownout, walked up ------------------------------
            t_w = time.perf_counter()
            stages = []      # (s after the first escalation, stage name)

            seen = [bo.transitions]

            async def watch_stages():
                while True:
                    if bo.transitions != seen[0]:
                        seen[0] = bo.transitions
                        stages.append((time.perf_counter() - t_w,
                                       bo.state()["stage_name"]))
                    await asyncio.sleep(0.005)

            watcher = asyncio.ensure_future(watch_stages())

            async def escalate(stage: int):
                ev = {"objective": "ttft:interactive", "from": "ok",
                      "to": "breach", "fast_burn": 99.0, "slow_burn": 9.0,
                      "threshold_s": 0.5}
                for _ in range(400):
                    if bo.on_slo_event(ev) and bo.stage == stage:
                        return
                    await asyncio.sleep(0.01)
                raise AssertionError(f"8k: the brownout never reached "
                                     f"stage {stage} ({bo.state()})")

            await escalate(1)
            res["shed"] = await asyncio.to_thread(
                http_chat_refused, port, body(texts[2]),
                {"x-dyn-class": "batch"})
            res["interactive"] = await chat(0, cls="interactive")
            await escalate(2)
            res["standard"] = await chat(1, max_tokens=64)
            await escalate(3)
            res["spec_shrink"] = eng.spec_shrink
            bo.on_slo_event({"objective": "ttft:interactive",
                             "from": "breach", "to": "ok"})
            res["clean_at"] = time.perf_counter() - t_w

            # wave 3 meanwhile: repeats over the small pool ----------------
            t_r = time.perf_counter()
            repeats = []
            for _ in range(ADMISSION_REPEATS):
                repeats.append(list(await asyncio.gather(
                    *(chat(i, "bronze" if i < 8 else "gold")
                      for i in range(ADMISSION_WAVE)))))
                prem = eng.kv_lifecycle.summary()["premature_evictions"]
                if prem and any(e["controller"] == "kvbm"
                                for e in plane.events()):
                    break
            res["repeats_wall"] = time.perf_counter() - t_r
            res["repeats"] = repeats
            for _ in range(3000):
                if bo.stage == 0:
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.01)
            watcher.cancel()
            res["stages"] = stages
            res["wave2_wall"] = time.perf_counter() - t_w
            res["kv"] = eng.kv_lifecycle.summary()
            # the brownout's transitions, all of them, from the event bus
            sub = await rt.events.subscribe(BROWNOUT_EVENTS_SUBJECT,
                                            from_start=True)
            bus = []
            while not sub.queue.empty():
                bus.append(sub.queue.get_nowait()["payload"])
            res["bus"] = bus
            res["tenants"] = await asyncio.to_thread(get, "/debug/tenants")
            res["classes"] = await asyncio.to_thread(get, "/debug/classes")
            res["fleet"] = await asyncio.to_thread(get, "/fleet/status")

            # wave 3b: a rung proposed mid-serving -------------------------
            gen = random.Random(23)
            rung_reqs = [{"token_ids": [gen.randrange(cfg.vocab_size)
                                        for _ in range(n)],
                          "sampling": {"temperature": 0.0,
                                       "top_logprobs": 8},
                          "stop": {"max_tokens": 8}}
                         for n in RUNG_PROMPT_LENS]

            async def rung_wave():
                eng.clear_kv_blocks()
                t = time.perf_counter()
                got = list(await asyncio.gather(
                    *(collect(eng, r) for r in rung_reqs)))
                return got, time.perf_counter() - t

            before, res["rung_wall_a"] = await rung_wave()
            ladder = eng.bucket_ladder
            if ladder is None:
                raise AssertionError("8k: the bucket autotuner installed "
                                     "no ladder on the engine")
            long_req = {"token_ids": rung_reqs[0]["token_ids"][:40],
                        "sampling": {"temperature": 0.0},
                        "stop": {"max_tokens": 64}}
            n_log = len(adm.log)
            bg = asyncio.ensure_future(collect(eng, long_req))
            for _ in range(3000):
                if any(s.prefilled for s in eng._running):
                    break
                await asyncio.sleep(0.005)
            if not ladder.propose([RUNG]):
                raise AssertionError("8k: the rung was not staged")
            staged = time.perf_counter()
            rec = eng.step_recorder
            n_rec = rec.recorded
            after, res["rung_wall_b"] = await rung_wave()
            res["rung_waits"] = [w for t, n, w, _ in adm.log[n_log:]
                                 if n in RUNG_PROMPT_LENS]
            # every capture the wave met, its decode bursts' new lane
            # counts and table widths beside the prefill rounds' new T
            res["wave_b_captures"] = [
                (r["entry"], r["shape"], r["host_s"])
                for r in rec.snapshot(rec.recorded - n_rec)
                if r["compiled"]]
            await bg
            again, res["rung_wall_c"] = await rung_wave()
            res["rung"] = (before, after, again, ladder.state(),
                           time.perf_counter() - staged)
            res["launches"] = cuda_build.launch_counts()
            rows = {}
            for r in eng.step_recorder.snapshot():
                if r["entry"] == "prefill":
                    row = rows.setdefault(r["shape"], [0, 0, 0.0, 0, 0])
                    row[0] += 1
                    row[1] += 1 if r["compiled"] else 0
                    row[2] += r["host_s"] if r["compiled"] else 0.0
                    row[3] += r["good_tokens"]
                    row[4] += r["work_tokens"]
            res["prefill_rows"] = rows
            res["control"] = await asyncio.to_thread(
                get, "/debug/control?limit=256")
            # read together, no await between: the plane ticks on this loop
            kv_moves = [e for e in plane.events()
                        if e["controller"] == "kvbm"]
            res["kvbm_moves"] = kv_moves
            res["watermark"] = eng.config.watermark
            res["plane_summary"] = plane.summary()
            return res
        finally:
            if fe is not None:
                await fe.stop()
            if handle is not None:
                await handle.stop()
            await eng.close()
            await rt.close()
            clients.shutdown()

    with env_set(DYN_TENANCY=json.dumps(tenancy),
                 DYN_CLASSES=json.dumps(classes), DYN_CONTROL="all",
                 DYN_CONTROL_INTERVAL_S="0.5", DYN_STEP_PROFILE="1",
                 DYN_KV_LIFECYCLE="1"):
        t0 = time.perf_counter()
        res = asyncio.run(armed())
        armed_wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # wave 1 ------------------------------------------------------------------
    order = res["order"]
    first8 = order[:8]
    n_gold = first8.count("gold")
    log(f"[admission] wave 1 ({res['wave1_wall']:.1f} s): 8 bronze then 8 "
        f"gold queued behind the held device lock; admission order "
        f"{''.join(t[0] for t in order)} (b bronze, g gold); the first 8 "
        f"hold {n_gold} gold (FIFO: 0); on {smi}")
    if abs(n_gold - 6) > 1:
        raise AssertionError(f"8k: {n_gold} gold in the first 8 "
                             f"admissions {first8}, want 6 +- 1")
    peak = res["bronze_peak"]
    log(f"[admission] bronze's KV pages while gold ran: peak "
        f"{peak['bronze']} of its budget {budget} ({peak['samples']} "
        f"samples); prompt {plen} tokens")
    if not peak["samples"] or peak["bronze"] > budget:
        raise AssertionError(f"8k: bronze held {peak['bronze']} pages, "
                             f"budget {budget}")
    st, retry, etype = res["capped"]
    a0, a1 = res["capped_arrivals"]
    log(f"[admission] capped (token_rate 1, burst {capped_tokens}): the "
        f"first chat 200, the second HTTP {st} Retry-After {retry} "
        f"({etype}); engine arrivals {a0} -> {a1}")
    if st != 429 or not retry or int(retry) < 1 or \
            etype != "rate_limit_exceeded" or a0 != a1:
        raise AssertionError(f"8k: capped's second chat {res['capped']}, "
                             f"arrivals {a0} -> {a1}")
    got1 = [(r["tokens"], r["tops"]) for r in res["wave1"]]
    # wave 1 is texts 0..15 in order; capped's chat is text 0 again
    parts = compare_streams(want[:ADMISSION_WAVE] + [want[0]], got1,
                            "admission wave 1")
    for rep in res["repeats"]:
        parts += compare_streams(
            want[:ADMISSION_WAVE], [(r["tokens"], r["tops"]) for r in rep],
            "admission repeat")
    log(f"[admission] {len(got1)} wave-1 streams and "
        f"{sum(len(r) for r in res['repeats'])} repeats equal to the "
        f"unarmed engine's token for token but {len(parts)} partings at "
        f"near-ties; on {smi}")

    # wave 2 ------------------------------------------------------------------
    st, retry, etype = res["shed"]
    inter, std = res["interactive"], res["standard"]
    log(f"[admission] brownout stage 1: batch chat HTTP {st} Retry-After "
        f"{retry} ({etype}), interactive chat 200 ({len(inter['tokens'])} "
        f"tokens); stage 2: standard chat asked 64, got "
        f"{std['usage']['completion_tokens']} ({std['finish']}); stage 3: "
        f"spec_shrink {res['spec_shrink']} (no draft: inert)")
    if st != 503 or retry != "3" or etype != "overloaded":
        raise AssertionError(f"8k: the shed batch chat {res['shed']}")
    if std["usage"]["completion_tokens"] > 32 or (
            std["finish"] == "length"
            and std["usage"]["completion_tokens"] != 32):
        raise AssertionError(f"8k: the capped standard chat {std['usage']}")
    if res["spec_shrink"] is not True:
        raise AssertionError("8k: stage 3 did not set spec_shrink")
    parts += compare_streams([want[0], want[ADMISSION_WAVE]],
                             [(inter["tokens"], inter["tops"]),
                              (std["tokens"], std["tops"])],
                             "admission brownout")
    bus = res["bus"]
    moves = [(e["from"], e["to"]) for e in bus]
    log("[admission] brownout transitions (s into wave 2; the `ok` at "
        f"{res['clean_at']:.2f} s): "
        + "; ".join(f"{t:.2f} -> {name}" for t, name in res["stages"])
        + "; reasons: " + "; ".join(f"{e['from']} -> {e['to']} "
                                    f"({e['reason']})" for e in bus))
    want_moves = [("ok", "shed_batch"), ("shed_batch", "cap_standard"),
                  ("cap_standard", "shrink_spec"),
                  ("shrink_spec", "cap_standard"),
                  ("cap_standard", "shed_batch"), ("shed_batch", "ok")]
    if moves != want_moves:
        raise AssertionError(f"8k: brownout transitions {moves}")
    ring = [e for e in res["control"]["events"]
            if e["controller"] == "brownout"]
    if [(e["from"], e["to"]) for e in ring] != want_moves[3:]:
        raise AssertionError(f"8k: /debug/control's brownout actions "
                             f"{ring}")
    # the machine and the plane tick on one clock: each step down waits
    # recover_s of clean time, the first one counted from the `ok`
    recover = classes["brownout_recover_s"]
    downs = [t for t, _ in res["stages"][3:]]
    if not downs or downs[0] - res["clean_at"] < recover - 0.05 or any(
            not recover <= e["evidence"]["clean_s"] < recover + 2.0
            for e in ring):
        raise AssertionError(
            f"8k: the walk-back did not wait recover_s {recover}: the "
            f"`ok` at {res['clean_at']:.3f} s, steps down at {downs}, "
            f"clean_s {[e['evidence']['clean_s'] for e in ring]}")
    cls = res["classes"]
    fleet = res["fleet"]
    if cls["brownout"]["transitions"] != 6 or cls["brownout"]["stage"] != 0 \
            or fleet["brownout"]["stage_name"] != "ok" or \
            "control" not in fleet:
        raise AssertionError(f"8k: /debug/classes brownout "
                             f"{cls['brownout']}, /fleet/status "
                             f"{fleet.get('brownout')}")
    log(f"[admission] class table: {cls['counters']}; brownout "
        f"{cls['brownout']}; /fleet/status brownout "
        f"{fleet['brownout']['stage_name']}, control actions "
        f"{fleet['control']['actions']}; wave 2 and the repeats "
        f"{res['wave2_wall']:.1f} s; on {smi}")
    for name, row in sorted(res["tenants"]["tenants"].items()):
        log(f"[admission] tenant {name}: admitted {row['admitted']}, "
            f"rejected {row['rejected']}, live streams "
            f"{row['live_streams']}, bucket {row['bucket_level']}")
    for e in res["tenants"]["engines"]:
        for name, row in sorted(e["tenants"].items()):
            log(f"[admission] engine tenant {name}: goodput "
                f"{row.get('goodput_tokens')} tokens, queue wait mean "
                f"{row.get('queue_wait_mean_s')} s, service "
                f"{row.get('service')}, deficit "
                f"{row.get('weighted_deficit')}")

    # wave 3: the controllers ------------------------------------------------
    kv = res["kv"]
    kv_moves = res["kvbm_moves"]
    log(f"[admission] wave 3: {len(res['repeats'])} repeat(s) of wave 1 "
        f"({res['repeats_wall']:.1f} s) over {ADMISSION_PAGES - 1} pages: "
        f"{kv['allocations']} allocations, {kv['premature_evictions']} "
        f"premature evictions, {kv['hits']} hits")
    for e in res["control"]["events"]:
        log(f"[admission] control action #{e['seq']} at {e['at']:.3f}: "
            f"{e['controller']} {e['knob']} {e['from']} -> {e['to']} "
            f"({e['reason']}); evidence {json.dumps(e['evidence'])[:240]}")
    if not kv["premature_evictions"] or not kv_moves:
        raise AssertionError(f"8k: premature evictions "
                             f"{kv['premature_evictions']}, kvbm actions "
                             f"{kv_moves}")
    for e in kv_moves:
        step = round(abs(e["to"] - e["from"]), 4)
        if e["knob"] != "watermark/w0" or step != 0.01 or \
                e["to"] < 0.80 or "window" not in e["evidence"]:
            raise AssertionError(f"8k: a KVBM action out of bounds: {e}")
    if res["watermark"] != kv_moves[-1]["to"]:
        raise AssertionError(f"8k: watermark {res['watermark']} != the "
                             f"last action's {kv_moves[-1]['to']}")
    bucket_moves = [e for e in res["control"]["events"]
                    if e["controller"] == "bucket"]
    log(f"[admission] bucket autotuner: {len(bucket_moves)} proposals over "
        f"{res['plane_summary']['ticks']} ticks (its two-dim labels never "
        f"match the engine's (width, tokens, aligned) prefill rows); KVBM "
        f"tuner: {len(kv_moves)} watermark moves, the engine's watermark "
        f"{res['watermark']}")
    if bucket_moves:
        raise AssertionError(f"8k: the bucket autotuner proposed "
                             f"{bucket_moves}")
    before, after, again, lad, staged_s = res["rung"]
    rows = res["prefill_rows"]
    old = {k: v for k, v in rows.items() if f"x{RUNG}x" not in k
           and "x384x" in k}
    new = {k: v for k, v in rows.items() if f"x{RUNG}x" in k}
    for k, (n, nc, cs, g, w) in sorted(rows.items()):
        log(f"[admission] prefill {k}: {n} dispatches, {nc} captures "
            f"({cs:.3f} s), padded {100.0 * (w - g) / max(w, 1):.2f}%")
    if lad["rungs"] != [RUNG] or lad["applied"] != 1 or not new or \
            sum(v[0] for v in new.values()) <= sum(
                v[1] for v in new.values()):
        raise AssertionError(f"8k: the rung {lad}, rows {rows}")

    def padded(group):
        g = sum(v[3] for v in group.values())
        w = sum(v[4] for v in group.values())
        return 100.0 * (w - g) / max(w, 1)

    if not old or padded(new) >= padded(old):
        raise AssertionError(f"8k: padding {padded(old):.2f}% at 384, "
                             f"{padded(new):.2f}% at {RUNG}")
    parts_b = compare_streams(before, after, "admission rung") + \
        compare_streams(before, again, "admission rung replay")
    met = ", ".join(f"{e} {sh} {t:.3f} s"
                    for e, sh, t in res["wave_b_captures"])
    captures = sum(v[1] for v in new.values())
    capture_s = sum(v[2] for v in new.values())
    log(f"[admission] rung {RUNG} proposed while a 64-token request "
        f"decoded, adopted at the scheduler's safe point ({lad}); prompts "
        f"of {RUNG_PROMPT_LENS[0]}-{RUNG_PROMPT_LENS[-1]} tokens: padded "
        f"{padded(old):.2f}% at 384 -> {padded(new):.2f}% at {RUNG}; the "
        f"new prefill shapes cost {captures} capture(s), {capture_s:.3f} "
        f"s; the wave met {len(res['wave_b_captures'])} captures in all, "
        f"{sum(c[2] for c in res['wave_b_captures']):.3f} s ({met}); "
        f"the longest queue wait of the wave {max(res['rung_waits']):.3f} "
        f"s; streams before / after / replayed equal but {len(parts_b)} "
        f"near-tie partings; walls {res['rung_wall_a']:.2f} / "
        f"{res['rung_wall_b']:.2f} / {res['rung_wall_c']:.2f} s; on {smi}")
    launches = res["launches"]
    for k in ("ragged_paged_attention", "paged_kv_write",
              "paged_kv_write_pages", "paged_attention_decode"):
        if not launches.get(k):
            raise AssertionError(f"8k: {k} never launched ({launches})")
    log(f"[admission] launches over the armed deployment {launches}; "
        f"armed part {armed_wall:.1f} s; on {smi}")
    out.update(order=order, n_gold=n_gold, bronze_peak=peak["bronze"],
               transitions=bus, kvbm_moves=kv_moves,
               watermark=res["watermark"], rung=lad,
               padded=(padded(old), padded(new)), captures=captures,
               capture_s=capture_s, max_wait=max(res["rung_waits"]),
               wave_b_captures=res["wave_b_captures"],
               partings=len(parts) + len(parts_b),
               walls=(res["wave1_wall"], res["wave2_wall"],
                      res["rung_wall_a"], res["rung_wall_b"],
                      res["rung_wall_c"]))
    return out


# -- the router's recorders and the mock fleet (phases 8d, 8j) ----------------

RADIX_BUILD = {}          # phase 2: {"seconds": g++ seconds, "path": library}
MOCK_IDS = (11, 12, 13, 14)
MOCK_PREFIXES, MOCK_PER_PREFIX, MOCK_PREFIX_WORDS = 16, 4, 256
FLEET_WORKERS, FLEET_BLOCKS, FLEET_QUERIES = 32, 4096, 1000
KV_BLOCK_NBYTES_8B = 32 * 2 * 8 * 128 * 16 * 2      # one 8B bf16 KV block


def build_native_radix() -> None:
    """Phase 2: the router's C++ radix index (host code) built from the
    checkout with g++, as its first use in a process would build it."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.native import radix

    t0 = time.perf_counter()
    if not radix.native_radix_available():
        raise AssertionError("the native radix index did not build")
    RADIX_BUILD.update(
        seconds=native.build_seconds.get("radix",
                                         time.perf_counter() - t0),
        path=str(native.library_path("radix")))
    log(f"[build] native radix index {RADIX_BUILD['path']} in "
        f"{RADIX_BUILD['seconds']:.2f} s (g++ -O3, host code)")


def chat_ids(pre, text: str) -> list:
    """The prompt token ids a frontend's preprocessor gives a one-message
    chat (`pre`: an OpenAIPreprocessor with the card's tokenizer)."""
    from dynamo_tpu_torch.llm.protocols_openai import ChatCompletionRequest

    return pre.preprocess_chat(ChatCompletionRequest.from_dict(
        {"model": pre.model_name,
         "messages": [{"role": "user", "content": text}]})).token_ids


def settle_router(port: int, timeout: float = 30.0) -> dict:
    """Until the frontend's router has consumed every KV event it will
    see (its kv event count stable for a second) and its capture has
    written them all: its /debug/router body."""
    end = time.perf_counter() + timeout
    last, since = None, time.perf_counter()
    while True:
        dbg = json.loads(_http_get(port, "/debug/router?limit=1024"))
        m = dbg["models"][0]
        n = m["counters"]["events"].get("kv", 0)
        rec = m.get("kv_record") or {}
        if n != last:
            last, since = n, time.perf_counter()
        elif (time.perf_counter() - since >= 1.0
              and rec.get("events") == n
              and len(capture_rows(rec["path"])) == n):
            return m
        if time.perf_counter() > end:
            raise AssertionError(f"the router never settled: {n} events, "
                                 f"capture {rec}")
        time.sleep(0.2)


def capture_rows(path: str) -> list:
    from dynamo_tpu_torch.runtime.recorder import Recorder

    if not os.path.exists(path):
        return []
    return list(Recorder.iter_events(path))


def replay_check(label: str, dbg: dict, prompts: list, bs: int,
                 n_decisions: int) -> tuple:
    """The frontend's KV-event capture (`dbg`: its settled /debug/router
    body) replayed into a fresh native and a fresh Python `KvIndexer`:
    at each recorded decision, both give the overlap the live router
    scored for every candidate (events recorded before the decision
    applied; the prompt found by its token count among `prompts`); after
    the last event, both hold the live index's blocks per worker and
    agree on every prompt. Returns (native indexer, Python indexer)."""
    from dynamo_tpu_torch.protocols import KvCacheEvent
    from dynamo_tpu_torch.router.decision_log import worker_label
    from dynamo_tpu_torch.router.indexer import KvIndexer

    rows = capture_rows(dbg["kv_record"]["path"])
    if dbg["index"].get("tree") != "native":
        raise AssertionError(f"{label}: the frontend's index is "
                             f"{dbg['index'].get('tree')}, not native")
    records = sorted((r for r in dbg["records"] if r["mode"] == "route"),
                     key=lambda r: r["at"])
    if len(records) != n_decisions:
        raise AssertionError(f"{label}: {len(records)} decisions recorded, "
                             f"want {n_decisions}")
    by_len: dict = {}
    for p in prompts:
        by_len.setdefault(len(p), []).append(p)
    nat, py = KvIndexer(bs), KvIndexer(bs, use_native=False)
    if nat.tree.kind != "native":
        raise AssertionError(f"{label}: no native tree in this process")

    def scores(idx, p) -> dict:
        return {worker_label(w): s for w, s in
                idx.find_matches_for_tokens(p).scores.items()}

    i = 0
    for rec in records:
        while i < len(rows) and rows[i][0] <= rec["at"]:
            ev = KvCacheEvent.from_dict(rows[i][1])
            nat.apply_event(ev)
            py.apply_event(ev)
            i += 1
        want = {c["worker"]: c["overlap_blocks"]
                for c in rec["candidates"] if c["overlap_blocks"]}
        if not any(scores(nat, p) == scores(py, p) == want
                   for p in by_len.get(rec["n_tokens"], ())):
            raise AssertionError(f"{label}: replay disagrees with the live "
                                 f"decision {rec['request_id']} "
                                 f"({rec['n_tokens']} tokens): {want}")
    for _, ev in rows[i:]:
        ev = KvCacheEvent.from_dict(ev)
        nat.apply_event(ev)
        py.apply_event(ev)
    live = {k: v for k, v in dbg["index"]["index_blocks"].items() if v}
    for idx in (nat, py):
        got = {worker_label(w): idx.tree.block_count(w)
               for w in idx.tree.workers()}
        got = {k: v for k, v in got.items() if v}
        if got != live:
            raise AssertionError(f"{label}: replayed blocks per worker "
                                 f"{got}, live index {live}")
    for p in prompts:
        if scores(nat, p) != scores(py, p):
            raise AssertionError(f"{label}: native and Python replays "
                                 f"part on a prompt")
    log(f"[{label}] capture {len(rows)} KV events replayed into a native "
        f"and a Python indexer: {len(records)} live decisions' candidate "
        f"overlaps reproduced, blocks per worker {live} equal to the live "
        f"index, {len(prompts)} prompts scored alike")
    return nat, py


def stored_chain(events) -> dict:
    """{seq hash: parent} over `stored` events (dicts or KvCacheEvents),
    each block's parent the one before it in its event."""
    out = {}
    for ev in events:
        d = ev if isinstance(ev, dict) else ev.to_dict()
        if d["kind"] != "stored":
            continue
        parent = d.get("parent_seq_hash")
        for seq, _local in d["blocks"]:
            out.setdefault(seq, parent)
            parent = seq
    return out


def mock_chain_check(rows: list, prompts: list, bs: int) -> int:
    """A MockEngine of block size `bs` given `prompts` (token ids): its
    `stored` events carry, block for block, the seq hashes and parents
    the real workers' captured `stored` events carry for the prompts'
    full blocks. Returns the blocks compared."""
    from dynamo_tpu_torch.mocker import MockEngine, MockEngineConfig
    from dynamo_tpu_torch.runtime.context import Context

    events: list = []
    eng = MockEngine(MockEngineConfig(block_size=bs, speedup=1000.0),
                     event_sink=events.append)

    async def go():
        for p in prompts:
            async for _ in eng.generate({"token_ids": p,
                                         "stop": {"max_tokens": 1}},
                                        Context()):
                pass
        await eng.close()

    asyncio.run(go())
    mock = stored_chain(events)
    real = stored_chain(e for _, e in rows)
    n = 0
    for p in prompts:
        from dynamo_tpu_torch.tokens import compute_seq_hashes

        for seq in compute_seq_hashes(p, bs):
            if seq not in mock or seq not in real or mock[seq] != real[seq]:
                raise AssertionError("the mocker's stored chain differs "
                                     "from the real workers'")
            n += 1
    return n


def prefix_duplication(port: int, nat, bs: int, nbytes: int,
                       n_decisions: int, label: str) -> dict:
    """GET /debug/prefixes: 200, `n_decisions` recorded, and duplication
    equal to what the replayed index implies: (k-1) blocks for every
    block resident on k workers, by depth bucket. The live plane is armed
    as the reference's router arms it, with no block size, so its buckets
    read 0 bytes: it is held to the block total and the bucket names. The
    port's plane over the replayed index, given `nbytes` a block, is held
    to the bytes of each bucket."""
    from dynamo_tpu_torch.router.prefix_plane import (
        PrefixHeatRecorder,
        depth_bucket,
    )

    st, raw = _http_status(port, "/debug/prefixes")
    if st != 200:
        raise AssertionError(f"{label}: /debug/prefixes HTTP {st}")
    body = json.loads(raw)["models"][0]
    s = body["summary"]
    if not body["enabled"] or s["decisions"] != n_decisions:
        raise AssertionError(f"{label}: /debug/prefixes enabled "
                             f"{body['enabled']}, {s['decisions']} "
                             f"decisions, want {n_decisions}")
    # the replayed index's own count: each block's depth down its parent
    # chain, and (k-1) blocks in that depth's bucket for k holders
    parent: dict = {}
    holders: dict = {}
    for ev in nat.tree.dump_events():
        p = ev.parent_seq_hash
        for b in ev.blocks:
            parent[b.seq_hash] = p
            holders.setdefault(b.seq_hash, set()).add(ev.worker_id)
            p = b.seq_hash

    def depth(h):
        d = 0
        while h in parent:
            h, d = parent[h], d + 1
        return d

    want: dict = {}
    for h, w in holders.items():
        if len(w) > 1:
            b = depth_bucket(depth(h))
            want[b] = want.get(b, 0) + len(w) - 1
    want_blocks = sum(want.values())
    rec = PrefixHeatRecorder(block_size=bs, block_nbytes=nbytes)
    rec.observe_index(nat)
    dup = rec.duplication()
    live = s["duplication"]
    if (live["duplicate_blocks"] != want_blocks
            or live["by_depth_bucket"] != {b: 0 for b in want}
            or dup["duplicate_blocks"] != want_blocks
            or dup["by_depth_bucket"] !=
            {b: n * nbytes for b, n in want.items()}):
        raise AssertionError(f"{label}: duplication live {live}, replayed "
                             f"{dup}, want blocks by depth bucket {want}")
    log(f"[{label}] /debug/prefixes: {s['decisions']} decisions, shadow "
        f"divergences {s['shadow_divergence']}, tier-blind "
        f"{s['tier_blind_total']}, shadow tokens saved "
        f"{s['shadow_tokens_saved_total']}; duplicate blocks "
        f"{live['duplicate_blocks']} (live) = {want_blocks} (replayed), "
        f"blocks by depth bucket {dict(sorted(want.items()))} (live bucket "
        f"names alike); the port's plane over the replayed index at "
        f"{nbytes / 2**20:.0f} MiB a block: bytes {dup['by_depth_bucket']}")
    return dup


def fleet_prefix_block(port: int, label: str) -> dict:
    """/fleet/status's frontend component carries the prefix block."""
    end = time.perf_counter() + 20
    while True:
        st, raw = _http_status(port, "/fleet/status")
        comps = json.loads(raw).get("components", ()) if st == 200 else ()
        blocks = [c["prefix"] for c in comps if c.get("prefix")]
        if blocks:
            log(f"[{label}] /fleet/status prefix block {blocks[0]}")
            return blocks[0]
        if time.perf_counter() > end:
            raise AssertionError(f"{label}: /fleet/status has no prefix "
                                 f"block (HTTP {st})")
        time.sleep(0.5)


def radix_log_line(svc) -> str:
    lines = [ln for ln in open(svc.err_path).read().splitlines()
             if "radix index:" in ln]
    if not lines or "native" not in lines[-1]:
        raise AssertionError(f"{svc.name} did not serve the native radix "
                             f"index: {lines}")
    return lines[-1].split("radix index: ", 1)[1]


def gpu_used_mib() -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()
    return int(out[0])


def compute_pids() -> set:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.split()
    return {int(x) for x in out if x.strip().isdigit()}


def mock_chat(port: int, text: str, stream: bool, max_tokens: int = 16
              ) -> dict:
    """One chat to the mock fleet: status, content, and for a stream the
    seconds to its first content delta."""
    import http.client

    body = {"model": "mock-model", "max_tokens": max_tokens,
            "stream": stream,
            "messages": [{"role": "user", "content": text}]}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if not stream:
            raw = r.read()
            out = json.loads(raw) if r.status == 200 else {}
            content = (out.get("choices") or [{}])[0].get(
                "message", {}).get("content")
            return {"status": r.status, "content": content,
                    "elapsed_s": time.perf_counter() - t0}
        first, parts = None, []
        for line in r:
            if line.startswith(b"data: {"):
                for ch in json.loads(line[6:])["choices"]:
                    delta = (ch.get("delta") or {}).get("content")
                    if delta and first is None:
                        first = time.perf_counter() - t0
                    parts.append(delta or "")
        return {"status": r.status, "content": "".join(parts),
                "ttft_s": first, "elapsed_s": time.perf_counter() - t0,
                "t0": t0}
    finally:
        conn.close()


def fleet_scale_radix(smi: str) -> None:
    """32 workers x 4096 blocks from a seeded event stream (chains over a
    shared prefix pool, as a fleet's system prompts and conversations
    share them), the native and the Python tree: the same scores and
    matched blocks on 1000 queries; host microseconds per find_matches."""
    from dynamo_tpu_torch.native.radix import CRadixTree
    from dynamo_tpu_torch.protocols import KvCacheEvent, StoredBlock
    from dynamo_tpu_torch.router.indexer import RadixTree
    from dynamo_tpu_torch.tokens import SEED_HASH, chain_hash

    rng = random.Random(19)
    pool = [[rng.randrange(1 << 30) for _ in range(64)] for _ in range(48)]
    nat, py = CRadixTree(), RadixTree()
    for w in range(1, FLEET_WORKERS + 1):
        while (held := nat.block_count((w, 0))) < FLEET_BLOCKS:
            chain = rng.choice(pool)[:rng.randint(8, 64)] + [
                rng.randrange(1 << 30) for _ in range(rng.randint(1, 32))]
            chain = chain[:FLEET_BLOCKS - held]
            seq, blocks = SEED_HASH, []
            for lh in chain:
                seq = chain_hash(seq, lh)
                blocks.append(StoredBlock(seq, lh))
            ev = KvCacheEvent(kind="stored", worker_id=w, blocks=blocks)
            nat.apply_event(ev)
            py.apply_event(ev)
    queries = [rng.choice(pool)[:rng.randint(1, 64)] + [
        rng.randrange(1 << 30) for _ in range(rng.randint(0, 8))]
        for _ in range(FLEET_QUERIES)]
    times = {}
    for name, tree in (("native", nat), ("python", py)):
        t0 = time.perf_counter()
        got = [tree.find_matches(q) for q in queries]
        times[name] = (time.perf_counter() - t0) / len(queries) * 1e6
        if name == "native":
            first = got
        elif any(a.scores != b.scores or a.matched_blocks != b.matched_blocks
                 for a, b in zip(first, got)):
            raise AssertionError("8j: native and Python trees part at "
                                 "fleet size")
    blocks = sum(nat.block_count(w) for w in nat.workers())
    log(f"[mock] fleet-size index: {len(nat.workers())} workers, {blocks} "
        f"blocks, {FLEET_QUERIES} queries scored alike; find_matches "
        f"{times['native']:.1f} us native vs {times['python']:.1f} us "
        f"Python per call ({times['python'] / times['native']:.1f}x; host "
        f"CPU of the card's machine beside {smi})")


def mock_fleet_phase(smi: str, work: str) -> dict:
    """Phase 8j: four mock workers behind the KV router on the card's
    machine (see the module docstring). Raises on any failed check."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import WordTokenizer
    from dynamo_tpu_torch.runtime.distributed import free_port

    rng = random.Random(10)
    words = [f"w{i}" for i in range(4000)]
    prefixes = [" ".join(rng.choice(words) for _ in range(MOCK_PREFIX_WORDS))
                for _ in range(MOCK_PREFIXES)]
    wave_b = [(k % MOCK_PREFIXES, prefixes[k % MOCK_PREFIXES] + " " + " ".join(
        rng.choice(words) for _ in range(12)))
        for k in range(MOCK_PREFIXES * MOCK_PER_PREFIX)]
    services = []
    out = {}
    try:
        coord = Service(work, "coordinator", "--port", str(free_port()))
        services.append(coord)
        store = coord.wait_line("COORDINATOR_READY", 120)
        used0, pids0 = gpu_used_mib(), compute_pids()
        mocks = []
        for wid in MOCK_IDS:
            m = Service(work, "worker", "--mock", "--mock-total-blocks",
                        "1024", "--migration-limit", "2", "--store", store,
                        "--instance-id", str(wid), label=f"mock{wid}")
            mocks.append(m)
            services.append(m)
        for m in mocks:
            m.wait_line("WORKER_READY", 120)
        time.sleep(1.0)
        used1, pids1 = gpu_used_mib(), compute_pids()
        on_card = {m.proc.pid for m in mocks} & pids1
        if on_card or used1 > used0:
            raise AssertionError(f"8j: mock workers touched the card: pids "
                                 f"{on_card} among {pids1}, used "
                                 f"{used0} -> {used1} MiB")
        log(f"[mock] 4 mock workers up: none among the card's compute "
            f"processes {sorted(pids1)} (pids as nvidia-smi sees them); "
            f"card memory used {used0} -> {used1} MiB ({smi})")

        def frontend(tag: str, mode: str = "kv", extra: tuple = (),
                     env: dict | None = None):
            port = free_port()
            cap = os.path.join(work, f"kv_capture_{tag}.jsonl")
            fe = Service(work, "frontend", "--store", store, "--host",
                         "127.0.0.1", "--port", str(port), "--router-mode",
                         mode, *extra, label=f"frontend_{tag}",
                         env={"DYN_KV_RECORD": cap, "DYN_PREFIX_HEAT": "1",
                              "DYN_ROUTER_LOG": "1", **(env or {})})
            services.append(fe)
            fe.wait_line("FRONTEND_READY", 120)
            end = time.perf_counter() + 60
            while b'"mock-model"' not in _http_get(port, "/v1/models"):
                if time.perf_counter() > end:
                    raise AssertionError("8j: the frontend never found "
                                         "the mock card")
                time.sleep(0.2)
            while mode == "kv" and json.loads(_http_get(
                    port, "/debug/router"))["models"][0]["index"][
                    "workers"] < len(MOCK_IDS):
                time.sleep(0.1)
            time.sleep(1.0)     # the push router's watch sees all four
            return fe, port

        fe, port = frontend("fleet")
        log(f"[mock] frontend index: {radix_log_line(fe)} (library built "
            f"in {RADIX_BUILD['seconds']:.2f} s in phase 2)")
        # the frontend's word tokenizer numbers words as it first sees
        # them: a preprocessor fed the same texts in the same order
        # gives the same token ids
        pre = OpenAIPreprocessor(WordTokenizer(), "mock-model")
        ids = {}
        t0 = time.perf_counter()
        for text in prefixes:
            ids[text] = chat_ids(pre, text)
            r = mock_chat(port, text, False)
            if r["status"] != 200:
                raise AssertionError(f"8j wave 1: HTTP {r['status']}")
        fe_m = _http_get(port, "/metrics").decode()
        saved0 = prometheus_value(fe_m,
                                  "dynamo_router_prefill_tokens_saved_total")
        for _, text in wave_b:
            ids[text] = chat_ids(pre, text)
            r = mock_chat(port, text, False)
            if r["status"] != 200:
                raise AssertionError(f"8j wave 2: HTTP {r['status']}")
        wall_ab = time.perf_counter() - t0
        fe_m = _http_get(port, "/metrics").decode()
        saved = prometheus_value(
            fe_m, "dynamo_router_prefill_tokens_saved_total") - saved0
        dbg = json.loads(_http_get(port, "/debug/router?limit=1024"))[
            "models"][0]
        recs = [r for r in dbg["records"] if r["mode"] == "route"]
        home = [recs[i]["worker"] for i in range(MOCK_PREFIXES)]
        wrong = [k for k, (p, _) in enumerate(wave_b)
                 if recs[MOCK_PREFIXES + k]["worker"] != home[p]]
        need = len(wave_b) * 15 * 16
        if wrong or saved < need:
            raise AssertionError(f"8j wave 2: {len(wrong)} requests off "
                                 f"their prefix's worker, prefill tokens "
                                 f"saved {saved} (want >= {need})")
        log(f"[mock] waves 1-2: {MOCK_PREFIXES} prefixes of "
            f"{MOCK_PREFIX_WORDS} words over workers "
            f"{sorted(set(home))}, then {len(wave_b)} requests one after "
            f"another, each on its prefix's worker; prefill tokens saved "
            f"{saved:.0f} (>= {need}) in {wall_ab:.1f} s")
        with ThreadPoolExecutor(len(wave_b)) as ex:
            w3 = list(ex.map(lambda t: mock_chat(port, t[1], True), wave_b))
        if any(r["status"] != 200 or r["ttft_s"] is None for r in w3):
            raise AssertionError("8j wave 3: a request failed")
        wall3 = max(r["t0"] + r["elapsed_s"] for r in w3) - \
            min(r["t0"] for r in w3)
        ttft = sorted(r["ttft_s"] * 1e3 for r in w3)
        out["decisions_per_s"] = len(w3) / wall3
        log(f"[mock] wave 3: the {len(w3)} again, all in flight: all 200; "
            f"TTFT p50 {statistics.median(ttft):.1f} ms, max "
            f"{ttft[-1]:.1f} ms; {out['decisions_per_s']:.1f} router "
            f"decisions/s over {wall3:.2f} s (host figures of the card's "
            f"machine, mock decode 4 ms a step; {smi})")
        dbg = settle_router(port)
        gaps = series_values(_http_get(port, "/metrics").decode(),
                             "dynamo_router_kv_event_gaps_total")
        if any(gaps.values()):
            raise AssertionError(f"8j: KV-event gaps {gaps}")
        prompts = [ids[t] for t in prefixes] + [ids[t] for _, t in wave_b]
        n_dec = MOCK_PREFIXES + 2 * len(wave_b)
        nat, _ = replay_check("mock", dbg, prompts, 16, n_dec)
        prefix_duplication(port, nat, 16, 1 << 20, n_dec, "mock")
        fleet_scale_radix(smi)
        fe.stop()
        services.remove(fe)

        # the fault pass: one refused dial, one mid-stream disconnect. A
        # KV decision names one instance, which a refused dial cannot
        # leave; round-robin routing walks the candidates, so the refused
        # dial goes to another instance
        spec = "kind=connect_refused,times=1;kind=disconnect,after=5,times=1"
        fe, port = frontend("faults", "round_robin", ("--faults", spec),
                            {"DYN_CONNECT_RETRIES": "0"})
        pre = OpenAIPreprocessor(WordTokenizer(), "mock-model")
        text = " ".join(rng.choice(words) for _ in range(40))
        prompt = chat_ids(pre, text)
        before = {w: requests_served(t)
                  for w, t in asyncio.run(worker_scrape(store)).items()}
        r = mock_chat(port, text, False)
        after = {w: requests_served(t)
                 for w, t in asyncio.run(worker_scrape(store)).items()}
        served = {w: after[w] - before.get(w, 0) for w in after}
        words_of = [pre.tokenizer.decode(
            prompt[:k] + (prompt + prompt[:k])[:16 - k]).split()
            for k in range(1, 16)]
        cut = [k + 1 for k, w in enumerate(words_of)
               if r["content"] is not None and r["content"].split() == w]
        fe_m = _http_get(port, "/metrics").decode()
        events = series_values(fe_m, "dynamo_transport_client_events")
        migrations = sum("migrating" in ln for ln in
                         open(fe.err_path).read().splitlines())
        refused = events.get('{kind="connect_failures"}', 0)
        retried = events.get('{kind="route_retries"}', 0)
        if (r["status"] != 200 or cut != [5] or refused != 1
                or retried != 1 or migrations != 1
                or sum(served.values()) != 2):
            raise AssertionError(f"8j faults: HTTP {r['status']}, content "
                                 f"{r['content']!r} (cut at {cut}), connect "
                                 f"failures {refused}, route retries "
                                 f"{retried}, migrations {migrations}, "
                                 f"served {served}")
        rest = [mock_chat(port, " ".join(rng.choice(words)
                                         for _ in range(30)), False)
                for _ in range(8)]
        if any(x["status"] != 200 for x in rest):
            raise AssertionError("8j faults: a request after the faults "
                                 "failed")
        log(f"[mock] faults ({spec}; DYN_CONNECT_RETRIES=0, round-robin "
            f"routing): the first dial was refused (connect failures "
            f"{refused:.0f}) and the router retried another instance "
            f"(route retries {retried:.0f}); the stream was cut after "
            f"{cut[0]} tokens and migrated (migrations {migrations}): its "
            f"tokens equal the undisturbed runs of the request's first "
            f"{cut[0]} tokens and of its replay (the prompt and those "
            f"tokens); requests served per worker {served}; 8 more "
            f"requests all 200; the injector fired 1 and 1")
        breaker_in_service_stats(store, MOCK_IDS[0])
    finally:
        for p in reversed(services):
            p.stop()
    return out


def breaker_in_service_stats(store: str, refused_id: int) -> None:
    """In process: a runtime whose transport refuses one dial to a mock
    worker routes around it; `ServiceClient.collect_services` over the
    runtime's own probe component shows the breaker's failure for that
    instance."""
    from dynamo_tpu_torch.protocols import PreprocessedRequest
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.faults import FaultInjector
    from dynamo_tpu_torch.runtime.push import PushRouter
    from dynamo_tpu_torch.runtime.service_stats import ServiceClient

    async def go():
        cfg = RuntimeConfig.from_env()
        cfg.store_url, cfg.connect_retries = store, 0
        rt = await DistributedRuntime.create(cfg)
        try:
            async def probe(request, context):
                yield {"ok": 1}

            await rt.namespace("dynamo").component("faultprobe").endpoint(
                "generate").serve(probe)
            client = await rt.namespace("dynamo").component(
                "backend").endpoint("generate").client()
            await client.start()
            await client.wait_ready()
            addr = next(i.address for i in client.instances()
                        if i.instance_id == refused_id)
            rt.transport_client.fault_injector = FaultInjector.from_spec(
                f"kind=connect_refused,addr={addr}")
            router = PushRouter(client)
            req = PreprocessedRequest(token_ids=[1, 2, 3], model="m")
            req.stop.max_tokens = 2
            inj = rt.transport_client.fault_injector
            for _ in range(len(MOCK_IDS)):
                async for _ in router.generate(req.to_dict(), Context()):
                    pass
                if inj.fired:
                    break       # a later success would reset the count
            stats = await ServiceClient(rt).collect_services(
                "dynamo", "faultprobe")
            await client.stop()
            return (rt.transport_client.fault_injector.fired, stats)
        finally:
            await rt.close()

    fired, stats = asyncio.run(go())
    (extras,) = stats.client_stats.values()
    failed = {k: v for k, v in extras["breaker"]["instances"].items()
              if v.get("failures")}
    if fired != {"connect_refused": 1} or list(failed) != [
            f"dynamo.backend.generate-{refused_id:x}"]:
        raise AssertionError(f"8j: breaker failures {failed} after "
                             f"{fired}")
    log(f"[mock] ServiceClient.collect_services: the probe runtime's "
        f"breaker holds {failed} for the instance whose dial was refused "
        f"({refused_id}); transport {extras['transport']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dynamo_tpu_torch.engine import (
        attention,
        cuda_build,
        graphs,
        int4_mm,
        kernels,
        quant,
        ragged,
    )
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm import guided as guided_mod
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run.main import build_pipeline_for, run_batch
    from dynamo_tpu_torch.runtime.context import Context

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(label: str) -> None:
        """Each phase's seconds on a line of its own."""
        now = time.perf_counter()
        log(f"[phase-time] {label}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    sku, peaks = peaks_for(name)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | peaks as {sku}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {sorted(cuda_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f}s into {cuda_build.build_dir()}")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kname}: {line.strip()}")

    build_native_radix()
    lap("1-2 device and build")
    gen = torch.Generator().manual_seed(0)
    KVH, D, P, H = 8, 128, 16, 32
    N_PAGES, MAX_PAGES = 2048, 512

    # 3. K2 vs plain ---------------------------------------------------------
    B = 64
    kc = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, torch.bfloat16)
    vc = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, torch.bfloat16)
    slots = torch.randperm((N_PAGES - 1) * P, generator=gen)[:B]
    kv_pages = (1 + slots // P).to(torch.int32)
    kv_offs = (slots % P).to(torch.int32)
    kv_pages[-6:] = 0                      # padding rows → scratch page 0
    kv_offs[-6:] = 0
    kv_pages, kv_offs = kv_pages.to(dev), kv_offs.to(dev)
    k2_err = 0.0
    for layout in K2_LAYOUTS:
        k_rows, v_rows = (k2_rows(torch, gen, dev, B, KVH, D, layout)
                          for _ in range(2))
        want_k, want_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_ref(want_k, want_v, k_rows, v_rows, kv_pages,
                                   kv_offs)
        got_k, got_v = kc.clone(), vc.clone()
        kernels.paged_kv_write(got_k, got_v, k_rows, v_rows, kv_pages,
                               kv_offs)
        torch.cuda.synchronize()
        err = max((got_k[:, 1:].float() - want_k[:, 1:].float()).abs().max()
                  .item(), (got_v[:, 1:].float() - want_v[:, 1:].float())
                  .abs().max().item())
        if err != 0.0 or not (torch.equal(got_k[:, 1:], want_k[:, 1:])
                              and torch.equal(got_v[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K2 differs from its plain version on "
                                 f"{layout} sources: {err}")
        k2_err = max(k2_err, err)
    log(f"[k2] paged_kv_write B={B} KVH={KVH} D={D} P={P} N={N_PAGES}, "
        f"sources {K2_LAYOUTS}: bit-exact outside page 0")
    lap("3 K2")

    # 4. K3 vs plain ---------------------------------------------------------
    M = 40
    slot_ids = (1 + torch.randperm(N_PAGES - 1, generator=gen)[:M]) \
        .to(torch.int32)
    slot_ids[[5, 17, 30, 31, 39]] = 0      # padding slots → scratch page 0
    slot_ids = slot_ids.to(dev)
    k3_err = 0.0
    for layout in K3_LAYOUTS:
        k_blocks, v_blocks = (k3_blocks(torch, gen, dev, M, KVH, P, D, layout)
                              for _ in range(2))
        want_k, want_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_pages_ref(want_k, want_v, k_blocks, v_blocks,
                                         slot_ids)
        got_k, got_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_pages(got_k, got_v, k_blocks, v_blocks,
                                     slot_ids)
        torch.cuda.synchronize()
        err = max((got_k[:, 1:].float() - want_k[:, 1:].float()).abs().max()
                  .item(), (got_v[:, 1:].float() - want_v[:, 1:].float())
                  .abs().max().item())
        if err != 0.0 or not (torch.equal(got_k[:, 1:], want_k[:, 1:])
                              and torch.equal(got_v[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"{layout} blocks: {err}")
        k3_err = max(k3_err, err)
    log(f"[k3] paged_kv_write_pages M={M} (5 padding slots on page 0) "
        f"KVH={KVH} P={P} D={D} N={N_PAGES}, blocks {K3_LAYOUTS}: bit-exact "
        f"outside page 0")
    del kc, vc, got_k, got_v, want_k, want_v
    lap("4 K3")

    # 5. K1 vs plain ---------------------------------------------------------
    decode_ctx = [1, 17, 100, 511, 1024, 2047, 3000, 4096]
    mixes = {   # (decode contexts, chunks (start, rows), padding rows)
        "mixed": (decode_ctx, [(1000, 100), (0, 60), (7, 25)], 12),
        "decode": (decode_ctx, [], 2),     # few rows: split-KV path
    }
    plain_k1 = blocked_plain_attention(ragged, torch)
    k1_err = {}
    for (label, mix), (dtype, tol) in itertools.product(
            mixes.items(), ((torch.bfloat16, K1_BF16_TOL),
                            (torch.float32, K1_FP32_TOL))):
        qpos, lanes, tables = attention_mix(torch, gen, N_PAGES, P,
                                            MAX_PAGES, *mix)
        qpos_d, lanes_d, tables_d = (x.to(dev)
                                     for x in (qpos, lanes, tables))
        grid = (ragged.grid_ctas(dev) if dtype == torch.bfloat16 else
                ragged.num_splits(qpos.numel(), KVH, MAX_PAGES,
                                  ragged.sm_count(dev)))
        q = torch.randn(qpos.numel(), H, D, generator=gen).to(dev, dtype)
        kp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, dtype)
        vp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, dtype)
        got = ragged.ragged_paged_attention(q, kp, vp, qpos_d, lanes_d,
                                            tables_d)
        want = plain_k1(q, kp, vp, qpos_d, lanes_d, tables_d)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        pad = qpos_d < 0
        if not torch.all(got[pad] == 0):
            raise AssertionError("K1 padding rows are not exact zeros")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        at = want.flatten()[diff.argmax()].float().abs().item()
        k1_err[dtype] = max(k1_err.get(dtype, 0.0), err)
        log(f"[k1] ragged_paged_attention {label} {str(dtype)[6:]} rows="
            f"{qpos.numel()} {'grid' if dtype == torch.bfloat16 else 'splits'}"
            f"={grid} ctx<=4096: max_abs_err "
            f"{err:.3e} at |want| {at:.3f} ({tol})")
        del q, got, want
        if dtype == torch.bfloat16:
            uniform_check(ragged, plain_k1, torch, kp, vp, qpos_d, lanes_d,
                          tables_d, H, f"{label} ctx<=4096")
            qg = torch.randn(qpos.numel(), H, D, generator=gen).to(dev, dtype)
            deeper = torch.where(qpos_d >= 0, qpos_d + 1, qpos_d)
            graph_replay_check(
                torch, lambda: ragged.ragged_paged_attention(
                    qg, kp, vp, qpos_d, lanes_d, tables_d), qpos_d,
                [deeper, torch.full_like(qpos_d, -1), qpos_d.clone()],
                f"K1 {label} round")
            del qg
        del kp, vp
    lap("5 K1")

    # 6. K4 vs plain ---------------------------------------------------------
    k4_lengths = {  # lanes: page edges, empty lanes, long contexts
        "edges": [1, 15, 16, 17, 32, 0, 33, 0],
        "long": [0, 100, 511, 1024, 2047, 3000, 4096, 4000],
    }
    k4_err = {}
    for (label, lens), (dtype, tol) in itertools.product(
            k4_lengths.items(), ((torch.bfloat16, K4_BF16_TOL),
                                 (torch.float32, K4_FP32_TOL))):
        args = decode_case(torch, gen, dev, dtype, lens, N_PAGES, MAX_PAGES,
                           H, KVH, P, D)
        grid = (ragged.grid_ctas(dev) if dtype == torch.bfloat16 else
                ragged.num_splits(len(lens), KVH, MAX_PAGES,
                                  ragged.sm_count(dev)))
        got = attention.paged_attention_decode(*args)
        want = attention.paged_attention_decode_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        empty = args[3] == 0
        if not torch.all(got[empty] == 0):
            raise AssertionError("K4 length-0 lanes are not exact zeros")
        err = (got.float() - want.float()).abs().max().item()
        k4_err[dtype] = max(k4_err.get(dtype, 0.0), err)
        log(f"[k4] paged_attention_decode {label} {str(dtype)[6:]} "
            f"lanes={len(lens)} {'grid' if dtype == torch.bfloat16 else 'splits'}"
            f"={grid} lengths={lens}: max_abs_err "
            f"{err:.3e} ({tol})")
        if dtype == torch.bfloat16:
            zq = (torch.zeros_like(args[0]),) + args[1:]
            got = attention.paged_attention_decode(*zq)
            want = attention.paged_attention_decode_ref(
                *[a.float() if a.is_floating_point() else a for a in zq])
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, **K4_UNIFORM_TOL)
            log(f"[k4] {label} uniform attention (q = 0) bf16 vs fp32 plain: "
                f"max_abs_err {(got.float() - want).abs().max().item():.3e} "
                f"({K4_UNIFORM_TOL})")
            lens_d = args[3]
            graph_replay_check(
                torch, lambda: attention.paged_attention_decode(*args),
                lens_d, [lens_d.flip(0), torch.zeros_like(lens_d),
                         lens_d.clone()], f"K4 {label} lanes")
        del args, got, want
    lap("6 K4")

    # 3-6 at the draft's geometry (D 64), and K1 at a verify round --------
    d64 = draft_geometry_checks(torch, gen, dev, kernels, attention, ragged,
                                plain_k1, N_PAGES, MAX_PAGES)
    k1_err[torch.bfloat16] = max(k1_err[torch.bfloat16], d64["k1"])
    k4_err[torch.bfloat16] = max(k4_err[torch.bfloat16], d64["k4"])
    torch.cuda.empty_cache()
    lap("3-6 at D 64")

    # 7. K5 / K6 vs plain ---------------------------------------------------
    a8_err = {"w8a8": 0.0, "int4": 0.0}
    a8_w = {}
    for label, (k, n) in PROJECTIONS.items():
        w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        for mode in QUANT_MODES:
            qt = quant.quantize(w, quant._bits_of(mode),
                                quant._act_bits_of(mode))
            a8_w[(mode, label)] = qt
            fn, ref = a8_fns(int4_mm, mode)
            for m, dtype in itertools.product(
                    A8_MS, (torch.bfloat16, torch.float32)):
                x = a8_case(torch, gen, dev, m, k, dtype)
                got, want = fn(x, qt.q, qt.s), ref(x, qt.q, qt.s)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                a8_err[mode] = max(a8_err[mode], err)
                if not (torch.equal(got, want) and torch.all(got[0] == 0)):
                    raise AssertionError(
                        f"{GEMM_OF[mode]} {label} M={m} {dtype} differs from "
                        f"its plain version: {err}")
        del w
        log(f"[a8] K5 w8a8_matmul and K6 int4_matmul {label} K={k} N={n}, "
            f"M in {A8_MS}, bf16 and fp32, an all-zero row: bit-identical "
            f"with the plain versions")
    # grouped calls: q/k/v (wq, wk, wv) and gate/up of the same x
    groups = {"q/k/v": ("wq/wo", "wk/wv", "wk/wv"),
              "gate/up": ("gate/up", "gate/up")}
    for mode in QUANT_MODES:
        group_fn = (int4_mm.w8a8_matmul_group if mode == "w8a8"
                    else int4_mm.int4_matmul_group)
        _, ref = a8_fns(int4_mm, mode)
        for gname, members in groups.items():
            pairs = [(a8_w[(mode, lbl)].q, a8_w[(mode, lbl)].s)
                     for lbl in members]
            for m in (1, 8, 40, 65, 512):
                x = a8_case(torch, gen, dev, m, 4096, torch.bfloat16)
                outs = group_fn(x, pairs)
                torch.cuda.synchronize()
                for out, (q, sc) in zip(outs, pairs):
                    if not torch.equal(out, ref(x, q, sc)):
                        raise AssertionError(f"grouped {GEMM_OF[mode]} "
                                             f"{gname} M={m} differs")
        log(f"[a8] grouped {GEMM_OF[mode]} q/k/v and gate/up, M in (1, 8, "
            f"40, 65, 512): bit-identical with the plain version per weight")
    for mode, gname in (("w8a8", None), ("int4", None), ("w8a8", "q/k/v"),
                        ("int4", "gate/up")):
        x = a8_case(torch, gen, dev, 8, 4096, torch.bfloat16)
        if gname is None:
            fn, _ = a8_fns(int4_mm, mode)
            qt = a8_w[(mode, "gate/up")]
            call = (lambda fn=fn, qt=qt, x=x: [fn(x, qt.q, qt.s)])
        else:
            group_fn = (int4_mm.w8a8_matmul_group if mode == "w8a8"
                        else int4_mm.int4_matmul_group)
            pairs = [(a8_w[(mode, lbl)].q, a8_w[(mode, lbl)].s)
                     for lbl in groups[gname]]
            call = (lambda g=group_fn, p=pairs, x=x: g(x, p))
        call()                                # scratch exists before capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = call()
        x.mul_(-2.5)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(o, e) for o, e in zip(outs, call())):
            raise AssertionError(f"{GEMM_OF[mode]} {gname or ''} graph "
                                 f"replay differs from an eager call")
        log(f"[a8] {GEMM_OF[mode]} {gname or 'gate/up'} M=8 captured in a "
            f"CUDA graph, x changed in place, replayed: equal to an eager "
            f"call")
        del graph, outs
    del a8_w
    lap("7 K5/K6")

    # 7b. prefill attention through K1, and the KV gather -------------------
    # the phase batch's widest chunk round (prefill_chunk_budget 512): 8
    # lanes x 512 rows, contexts to 1041, cursors page-aligned and not,
    # one padding lane; valid rows against the plain function at K1's
    # tolerance, padding rows exact zeros (the plain version averages the
    # valid keys there, by design), and q = 0 through the same row tags
    pf_cached = [0, 512, 0, 529, 64, 0, 0, 0]
    pf_lens = [512, 1024, 300, 1041, 576, 16, 100, 0]
    pf_t, pf_bp = 512, len(pf_cached)
    pf_tables = torch.zeros(pf_bp, MAX_PAGES, dtype=torch.int32)
    free = (1 + torch.randperm(N_PAGES - 1, generator=gen)).tolist()
    for i in range(pf_bp):
        need = -(-(pf_cached[i] + pf_t) // P)
        pf_tables[i, :need] = torch.tensor(free[:need], dtype=torch.int32)
        free = free[need:]
    pf_tables = pf_tables.to(dev)
    pf_pos = (torch.tensor(pf_cached, dtype=torch.int32)[:, None]
              + torch.arange(pf_t, dtype=torch.int32)[None, :]).to(dev)
    pf_seq = torch.tensor(pf_lens, dtype=torch.int32).to(dev)
    pf_kp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                             torch.bfloat16)
    pf_vp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                             torch.bfloat16)
    pf_q = torch.randn(pf_bp, pf_t, H, D, generator=gen).to(dev,
                                                          torch.bfloat16)
    pf_valid = pf_pos < pf_seq[:, None]
    got = attention.prefill_attention(pf_q, pf_kp, pf_vp, pf_tables, pf_pos,
                                      pf_seq)
    want = attention.prefill_attention_ref(pf_q, pf_kp, pf_vp, pf_tables,
                                           pf_pos, pf_seq)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[pf_valid].float(),
                               want[pf_valid].float(), **K1_BF16_TOL)
    if not torch.all(got[~pf_valid] == 0):
        raise AssertionError("K1's prefill padding rows are not exact zeros")
    pf_err = (got[pf_valid].float() - want[pf_valid].float()).abs().max() \
        .item()
    k1_err[torch.bfloat16] = max(k1_err[torch.bfloat16], pf_err)
    pf_tags = attention.chunk_rows(pf_pos, pf_seq)
    uniform_check(ragged, plain_k1, torch, pf_kp, pf_vp, *pf_tags, pf_tables,
                  H, "prefill chunk round (bp 8, T 512, the phase path's "
                  "rows)")
    log(f"[k1] prefill_attention through K1, bp {pf_bp} T {pf_t} contexts to "
        f"{max(pf_lens)} (one padding lane), bf16: valid rows max_abs_err "
        f"{pf_err:.3e} ({K1_BF16_TOL}), {int((~pf_valid).sum())} padding "
        f"rows exact zeros")
    del got, want

    # the KV gather: a 1041-token prompt's 66 pages out of 32 layers' K and
    # V caches in one launch, bit-exact with the per-layer index_select
    g_dev = torch.Generator(device=dev).manual_seed(13)
    g_caches = tuple([torch.randn(KVH, N_PAGES, P, D, generator=g_dev,
                                  device=dev, dtype=torch.bfloat16)
                      for _ in range(N_LAYER_RUN)] for _ in range(2))
    g_ids = (1 + torch.randperm(N_PAGES - 1, generator=gen)[:66]).to(
        torch.int32).to(dev)
    g_ptrs = kernels.cache_pointers(*g_caches)
    got = kernels.paged_kv_gather(*g_caches, g_ids, g_ptrs)
    want = kernels.paged_kv_gather_ref(*g_caches, g_ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("the KV gather differs from its plain version")
    gather_err = (got.float() - want.float()).abs().max().item()
    log(f"[gather] paged_kv_gather 66 pages x {N_LAYER_RUN} layers x K,V "
        f"(KVH {KVH}, P {P}, D {D}, bf16; {got.nbytes} bytes): bit-exact "
        f"with the per-layer index_select stack")
    del got, want, g_caches, g_ptrs, pf_kp, pf_vp, pf_q
    torch.cuda.empty_cache()
    lap("7b prefill attention and gather")

    # 8. main paths --------------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ckpt = os.path.join(work, "llama3-8b")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(LLAMA3_8B_CONFIG, f)
    t0 = time.perf_counter()
    os.environ.pop("DYN_ATTENTION_IMPL", None)     # the default: phase
    engine, card = build_torch_engine(
        ckpt, "llama3-8b", num_pages=N_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, decode_steps_per_sync=8,
        pipeline_bursts=True, random_init=True, rng_seed=0, device="cuda")
    torch.cuda.synchronize()
    if engine.ragged:
        raise AssertionError("the default engine is not on the phase path")
    log(f"[main] Llama-3-8B random init + {N_PAGES}-page KV pool in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    jobs = write_jobs(os.path.join(work, "jobs.jsonl"), seed=0)
    args = type("Args", (), {"tokenizer": "auto", "context_length": None,
                             "max_tokens": 32})()
    model = engine.model
    cfg = model.cfg

    async def greedy_on(eng, prompt, n, top=0):
        """Greedy tokens of one request; with `top`, also each token's
        top-`top` [[id, logprob], ...]."""
        toks, tops = [], []
        async for o in eng.generate(
                {"token_ids": prompt,
                 "sampling": {"temperature": 0.0, "top_logprobs": top},
                 "stop": {"max_tokens": n}}, Context()):
            toks.extend(o.get("token_ids", ()))
            tops.extend(o.get("top_logprobs") or ())
        return (toks, tops) if top else toks

    def serve_batch(eng, label, must_launch, must_not_launch, graph_entries,
                    steady=False, batch_jobs=None, extra=None):
        """The batch (`batch_jobs`, default phase 8's 10 requests) through
        the pipeline with launch counts zeroed just before and read just
        after (graph replays included), the path's graphed entries
        captured and replayed (per entry: captures and their seconds),
        then, with `steady`, a second batch of fresh prompts of the same
        sizes (the steady state: the graphs exist), then greedy
        determinism, then `extra(eng)` (its result returned as "extra");
        one event loop for the engine, which is closed at the end."""
        pipeline = build_pipeline_for(card, eng, args)

        async def go():
            try:
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                results = await run_batch(pipeline, card.name,
                                          batch_jobs or jobs, 32,
                                          os.path.join(work, "out.jsonl"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = cuda_build.launch_counts()
                out_tokens, n_rounds = eng.tokens_emitted, eng.rounds
                ttft = list(eng.ttft_s)
                stats = graph_stats(eng)
                summary = graph_summary(eng)
                spec = None
                if eng.draft is not None:
                    spec = dict(eng._spec_stats.to_dict(), bursts=int(
                        eng.metrics.spec_bursts.get()))
                second = None
                if steady:
                    t0 = time.perf_counter()
                    await run_batch(pipeline, card.name, write_jobs(
                        os.path.join(work, "jobs_steady.jsonl"), seed=2), 32,
                        os.path.join(work, "out_steady.jsonl"))
                    torch.cuda.synchronize()
                    second = {"wall": time.perf_counter() - t0,
                              "tokens": eng.tokens_emitted - out_tokens,
                              "ttft": eng.ttft_s[len(ttft):],
                              "rounds": eng.rounds - n_rounds,
                              "captures": eng.graphs.captures
                              - stats["captures"],
                              "replays": eng.graphs.replays
                              - stats["replays"]}
                prompt = list(range(40, 140))
                same = await asyncio.gather(
                    greedy_on(eng, prompt, 12, top=8),
                    greedy_on(eng, prompt, 12, top=8))
                more = await extra(eng) if extra is not None else None
                return (results, wall, launches, out_tokens, n_rounds,
                        ttft, stats, summary, second, same, spec, more)
            finally:
                await eng.close()

        (results, wall, launches, out_tokens, n_rounds, ttft, stats, summary,
         second, (a, b), spec, more) = asyncio.run(go())
        log(f"[main] {label} path: {len(results)} requests, {out_tokens} "
            f"output tokens in {wall:.2f}s; {n_rounds} device dispatches "
            f"({eng.pipelined_bursts} pipelined bursts); launches "
            f"{launches}")
        log(f"[graph] {label} path batch: {summary}; the captures ran "
            f"inside the first requests' TTFT")
        log(f"[graph] {label} path first batch, captures by entry: "
            + "; ".join(f"{e} {n} in {sec:.3f} s" for e, (n, sec) in
                        sorted(stats["by_entry"].items())))
        if not set(graph_entries) <= set(stats["entries"]) or \
                not stats["replays"] > stats["captures"] > 0:
            raise AssertionError(f"the {label} batch did not replay its "
                                 f"{graph_entries} graphs: {stats}")
        for r in results:
            if r["finish_reason"] not in ("length", "eos") \
                    or r["completion_tokens"] < 1:
                raise AssertionError(f"request did not finish right: {r}")
        for kname in must_launch:
            if launches[kname] == 0:
                raise AssertionError(f"kernel {kname} never launched on the "
                                     f"{label} main path")
        for kname in must_not_launch:
            if launches[kname] != 0:
                raise AssertionError(f"kernel {kname} launched on the "
                                     f"{label} main path")
        if a[0] != b[0] or len(a[0]) != 12 or len(a[1]) != 12:
            raise AssertionError(f"greedy streams differ: {a[0]} vs {b[0]}")
        log(f"[main] {label} greedy determinism: two identical requests -> "
            f"{a[0][:6]}...")
        if second is not None:
            log(f"[batch] {label} path, first batch (graph captures inside): "
                f"{out_tokens / wall:.1f} output tok/s, TTFT p50 "
                f"{statistics.median(ttft) * 1e3:.1f} ms, {n_rounds} "
                f"dispatches, {stats['captures']} captures in "
                f"{stats['capture_s']:.3f} s; steady batch (fresh prompts of "
                f"the same sizes): {second['tokens'] / second['wall']:.1f} "
                f"output tok/s, TTFT p50 "
                f"{statistics.median(second['ttft']) * 1e3:.1f} ms, "
                f"{second['rounds']} dispatches, {second['captures']} new "
                f"captures, {second['replays']} replays; on {smi}")
        return {"wall": wall, "launches": launches, "tokens": out_tokens,
                "rounds": n_rounds, "ttft": ttft, "stream": a,
                "graphs": stats, "results": results, "steady": second,
                "spec": spec, "extra": more}

    phase = serve_batch(engine, "phase",
                        ("paged_kv_write", "paged_kv_write_pages",
                         "paged_attention_decode", "ragged_paged_attention"),
                        ("w8a8_matmul", "int4_matmul"), PHASE_ENTRIES,
                        steady=True)
    del engine
    torch.cuda.empty_cache()
    ragged_eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=N_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, attention_impl="ragged", device="cuda"),
        model=model)
    ragged_run = serve_batch(ragged_eng, "ragged",
                             ("ragged_paged_attention", "paged_kv_write"),
                             ("paged_kv_write_pages",
                              "paged_attention_decode", "w8a8_matmul",
                              "int4_matmul"), ("ragged_step",))
    del ragged_eng
    torch.cuda.empty_cache()
    # the same greedy request on both paths: equal up to a parting at a
    # bf16 near-tie, where each run ranks the other's token within
    # BF16_TIE_TOL nats of its own
    partings = stream_partings([phase["stream"]], [ragged_run["stream"]],
                               BF16_TIE_TOL)
    if partings:
        (_, step, gap), = partings
        toks = (phase["stream"][0][step], ragged_run["stream"][0][step])
        log(f"[main] greedy stream of the same 100-token prompt, phase vs "
            f"ragged path (bf16): part at step {step} of 12, tokens {toks[0]}"
            f" vs {toks[1]}, logprob gap {gap:.4f} nats (tie tolerance "
            f"{BF16_TIE_TOL}); identical before it")
    else:
        log(f"[main] greedy stream of the same 100-token prompt, phase vs "
            f"ragged path (bf16): identical over 12 steps")
    lap("8 main paths")

    # 8b. constrained sampling ---------------------------------------------
    t0 = time.perf_counter()
    constrained = constrained_phase(torch, model, dev, smi, N_PAGES)
    log(f"[constrained] phase 8b in {time.perf_counter() - t0:.1f} s")
    lap("8b constrained")

    # 8c. the port as a deployment ----------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_phase(torch, smi, work, ckpt, jobs, phase, model, llama)
    log(f"[serve] phase 8c in {time.perf_counter() - t0:.1f} s")
    lap("8c serving")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parser_phase(torch, smi, model, cuda_build, N_PAGES)
    log(f"[parsers] the parser run in {time.perf_counter() - t0:.1f} s")
    lap("8c parsers")

    # 8d. the KV router on the card -----------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kv_router_phase(torch, smi, work, ckpt, model, card, 2048)
    log(f"[kv] phase 8d in {time.perf_counter() - t0:.1f} s")
    lap("8d kv router")

    # 8e. disaggregated serving --------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    disagg = disagg_phase(torch, smi, work, ckpt, jobs, phase, model, 2048)
    log(f"[disagg] phase 8e in {time.perf_counter() - t0:.1f} s")
    lap("8e disagg")

    # 8j. the mock fleet and the wire faults ------------------------------
    t0 = time.perf_counter()
    mock_fleet_phase(smi, work)
    log(f"[mock] phase 8j in {time.perf_counter() - t0:.1f} s")
    lap("8j mock fleet")

    # 8f. KVBM ------------------------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kvbm_phase(torch, smi, model)
    torch.cuda.empty_cache()
    log(f"[kvbm] phase 8f in {time.perf_counter() - t0:.1f} s")
    lap("8f kvbm")

    # 8g. speculative decoding ---------------------------------------------
    from dynamo_tpu_torch.models.loader import config_from_hf

    dckpt = os.path.join(work, "llama3.2-1b")
    os.makedirs(dckpt)
    with open(os.path.join(dckpt, "config.json"), "w") as f:
        json.dump(DRAFT_1B_CONFIG, f)
    dcfg = config_from_hf(dckpt, page_size=cfg.page_size,
                          max_pages_per_seq=cfg.max_pages_per_seq,
                          dtype=cfg.dtype)
    draft = llama.init_params(dcfg, 1, dev)
    spec_kw = dict(num_pages=N_PAGES, max_batch_size=8,
                   prefill_chunk_budget=512, spec_gamma=SPEC_GAMMA,
                   spec_iters_per_sync=SPEC_ITERS, device="cuda")
    spec_entries = ("prefill", "prefill_draft", "sample_first",
                    "spec_decode")
    attn_kernels = ("paged_kv_write", "paged_kv_write_pages",
                    "paged_attention_decode", "ragged_paged_attention")

    async def seeded_runs(eng):
        """The same seeded request (temperature 0.8, top-8 logprobs) twice
        on an empty prefix cache, then once more with its prefix cached:
        [(tokens, top-8 of each token, prompt tokens found cached)] x 3."""
        req = {"token_ids": list(range(60, 200)),
               "sampling": {"temperature": 0.8, "seed": 1234,
                            "top_logprobs": 8},
               "stop": {"max_tokens": 24}}
        admit, cached = eng._alloc_admission, []

        def spy(*a):                # the admission's prefix-hit length
            out = admit(*a)
            if out is not None:
                cached.append(out[1])
            return out

        eng._alloc_admission = spy
        runs = []
        for clear in (True, True, False):
            if clear:
                eng.clear_kv_blocks()
            toks, tops = [], []
            async for o in eng.generate(dict(req), Context()):
                toks.extend(o.get("token_ids", ()))
                tops.extend(o.get("top_logprobs") or ())
            runs.append((toks, tops, cached[-1]))
        eng._alloc_admission = admit
        return runs

    def prefix_hit_effect(runs) -> str:
        """Whether the prefix-hit run's stream left the cold one's, and
        how far its first token's top-8 logprobs moved."""
        (cold, cold_top, _), _, (hit, hit_top, n_hit) = runs
        lp = dict((int(i), v) for i, v in cold_top[0])
        moved = max((abs(v - lp[int(i)]) for i, v in hit_top[0]
                     if int(i) in lp), default=float("nan"))
        step = next((i for i, (x, y) in enumerate(zip(cold, hit))
                     if x != y), None)
        same = step is None and len(hit) == len(cold)
        return (f"{n_hit} prompt tokens cached, "
                + (f"stream identical over {len(hit)} tokens" if same
                   else f"stream parts at step {step}")
                + f", first token's top-8 logprobs moved by at most "
                f"{moved:.4f} nats")

    spec_run = serve_batch(
        TorchEngine(TorchEngineConfig(model=cfg, draft_model=dcfg,
                                      **spec_kw), model=model, draft=draft),
        "spec (8B + 1B draft)", attn_kernels, ("w8a8_matmul", "int4_matmul"),
        spec_entries, steady=True, extra=seeded_runs)
    want = [token_ids_of(r["logprobs"]) for r in phase["results"]]
    parts = compare_streams(want, [token_ids_of(r["logprobs"])
                                   for r in spec_run["results"]], "spec")
    seeded = spec_run["extra"]
    (a, _, _), (b, _, _) = seeded[:2]
    if a != b or len(a) != 24:
        raise AssertionError(f"seeded spec streams differ: {a} vs {b}")
    st = spec_run["spec"]
    if not st["num_draft_tokens"] > 0:
        raise AssertionError(f"the spec batch proposed no draft token: {st}")
    # the same seeded request on a no-draft phase engine: does a prefix hit
    # move its stream as it moves the spec engine's?
    plain_eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=N_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, device="cuda"), model=model)

    async def plain_seeded():
        try:
            return await seeded_runs(plain_eng)
        finally:
            await plain_eng.close()

    plain_seeded_runs = asyncio.run(plain_seeded())
    del plain_eng
    plain_cold = [run[0] for run in plain_seeded_runs[:2]]
    log(f"[spec] seeded request (temperature 0.8, seed 1234, 140-token "
        f"prompt, 24 tokens): on the spec engine twice on an empty prefix "
        f"cache identical, {a[:6]}...; with a prefix hit: "
        f"{prefix_hit_effect(seeded)}. On a no-draft phase engine (its "
        f"decode draws other keys than the spec burst's): first token "
        f"cold equal to the spec engine's: {plain_cold[0][:1] == a[:1]}, twice "
        f"cold identical: {plain_cold[0] == plain_cold[1]}, with a prefix "
        f"hit: {prefix_hit_effect(plain_seeded_runs)}")
    n_pos, n_off, tie_gap = draft_verify_disagreement(torch, llama, model,
                                                      dev)
    with open(jobs) as f:
        jobs4 = os.path.join(work, "jobs_self_draft.jsonl")
        with open(jobs4, "w") as g:
            g.writelines(json.dumps(dict(json.loads(line), max_tokens=64))
                         + "\n" for line in f.readlines()[:4])
    self_run = serve_batch(
        TorchEngine(TorchEngineConfig(model=cfg, draft_model=cfg,
                                      **spec_kw), model=model, draft=model),
        "spec self-draft (8B + 8B)", attn_kernels,
        ("w8a8_matmul", "int4_matmul"), spec_entries, batch_jobs=jobs4)
    self_streams = [token_ids_of(r["logprobs"]) for r in self_run["results"]]
    self_parts = compare_streams(want[:4], [(t[:32], k[:32])
                                            for t, k in self_streams],
                                 "spec self-draft")
    sst = self_run["spec"]
    floor, expect = self_draft_floor(n_off / n_pos, n_pos,
                                     sst["num_draft_tokens"] // SPEC_GAMMA)
    log(f"[spec] draft (K4 decode steps) vs verify (K1 rows of gamma + 1) "
        f"argmax on the 8B model, teacher-forced over {n_pos} positions of "
        f"8 lanes: {n_off} differ (rate {n_off / n_pos:.4f}), at logit gaps "
        f"up to {tie_gap:.4f} nats; the self-draft's acceptance at that "
        f"rate {expect:.4f}, floor {floor:.4f} (`self_draft_floor`); on "
        f"{smi}")
    if not sst["acceptance_rate"] >= floor:
        raise AssertionError(f"self-draft acceptance {sst} below {floor:.4f}"
                             f", derived from the measured disagreement "
                             f"{n_off} of {n_pos}")
    steady = phase["steady"]
    for label, run, n_parts in (("8B + 1B draft", spec_run, len(parts)),
                                ("self-draft", self_run, len(self_parts))):
        rs, st2 = run["spec"], run["steady"]
        emitted = rs["num_accepted_tokens"] + rs["num_draft_tokens"] \
            // SPEC_GAMMA
        steady_txt = "" if st2 is None else (
            f"; steady batch (10 fresh prompts) "
            f"{st2['tokens'] / st2['wall']:.1f} tok/s, TTFT p50 "
            f"{statistics.median(st2['ttft']) * 1e3:.1f} ms, "
            f"{st2['captures']} new captures")
        log(f"[spec] {label}: {len(run['results'])} requests, "
            f"{len(run['results']) - n_parts} token-identical with phase 8's "
            f"no-draft batch, {n_parts} parted at near-ties; draft tokens "
            f"{rs['num_draft_tokens']}, accepted {rs['num_accepted_tokens']}"
            f" (rate {rs['acceptance_rate']:.4f}; random weights: a bound "
            f"on the path's cost, not a claim), {rs['bursts']} spec bursts, "
            f"{emitted / max(rs['bursts'], 1):.1f} tokens per burst (all "
            f"lanes); first batch (captures inside) "
            f"{run['tokens'] / run['wall']:.1f} output tok/s, TTFT p50 "
            f"{statistics.median(run['ttft']) * 1e3:.1f} ms "
            f"({run['graphs']['captures']} captures in "
            f"{run['graphs']['capture_s']:.3f} s){steady_txt}; phase 8's "
            f"no-draft steady batch {steady['tokens'] / steady['wall']:.1f} "
            f"tok/s, TTFT p50 {statistics.median(steady['ttft']) * 1e3:.1f} "
            f"ms; on {smi}")
    torch.cuda.empty_cache()
    lap("8g speculative decoding")

    # 8h. Mixtral-8x7B in int8, and image chat -------------------------------
    # the 8B weights and the 1B draft leave the card (47 GB of int8 Mixtral
    # and its pool do not fit beside them); phases 9-13 draw them again
    # from seeds 0 and 1, as phase 8's engine and phase 8g drew them
    del model, draft
    moe_phase(torch, smi, work)
    model = llama.init_params(cfg, 0, dev)
    draft = llama.init_params(dcfg, 1, dev)
    lap("8h moe and multimodal")

    # 8i. the engine's flight recorders ------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recorders_phase(torch, smi, work, card, model)
    log(f"[recorders] phase 8i in {time.perf_counter() - t0:.1f} s")
    lap("8i recorders")

    # 8k. the admission and control planes ---------------------------------
    torch.cuda.empty_cache()
    admission_phase(torch, smi, card, model)
    lap("8k admission and control")

    # 9. quantized main path -------------------------------------------------

    def bare_decode_launches(mdl):
        """One bare decode_step over 8 lanes: the launches it made."""
        kc, vc = llama.init_cache(cfg, 1 + 8 * 8, dev)
        tables = torch.zeros(8, cfg.max_pages_per_seq, dtype=torch.int32)
        tables[:, :8] = torch.arange(1, 65, dtype=torch.int32).reshape(8, 8)
        step = [torch.arange(8, dtype=torch.int32) * 11,            # tokens
                torch.tensor([5, 17, 40, 63, 100, 120, 7, 0],
                             dtype=torch.int32),                      # positions
                tables, torch.ones(8, dtype=torch.bool)]
        with torch.inference_mode():
            cuda_build.reset_launch_counts()
            logits = llama.decode_step(mdl, kc, vc,
                                       *(a.to(dev) for a in step))
            torch.cuda.synchronize()
            counts = cuda_build.launch_counts()
        if not torch.isfinite(logits).all() or logits.shape != (
                8, cfg.vocab_size):
            raise AssertionError("bare decode_step logits are not finite")
        return counts

    bf16_bytes = quant.weight_bytes(model)
    quantized, q_models = {}, {}
    # cut since 8g was added: each quantized batch serves every other of
    # phase 8's requests (16, 100, 350, 800, 1250 bytes)
    with open(jobs) as f:
        jobs_q = os.path.join(work, "jobs_quantized.jsonl")
        with open(jobs_q, "w") as g:
            g.writelines(f.readlines()[::2])
    for mode in QUANT_MODES:
        gemm = GEMM_OF[mode]
        other = GEMM_OF["int4" if mode == "w8a8" else "w8a8"]
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        q_engine, _ = build_torch_engine(
            ckpt, "llama3-8b", num_pages=N_PAGES, max_batch_size=8,
            prefill_chunk_budget=512, decode_steps_per_sync=8,
            pipeline_bursts=True, random_init=True, rng_seed=0,
            quantize=mode, device="cuda")
        torch.cuda.synchronize()
        q_model = q_engine.model
        check_quantized(torch, quant, q_model, mode)
        q_bytes = quant.weight_bytes(q_model)
        proj_bytes = sum(getattr(layer, key).nbytes
                         for layer in q_model.layers
                         for key in quant.QUANT_KEYS)
        log(f"[quant] {mode}: Llama-3-8B random init (seed 0) quantized by "
            f"the engine in {time.perf_counter() - t0:.1f}s; resident weight "
            f"bytes {q_bytes} ({q_bytes / 2**30:.3f} GiB; projections "
            f"{proj_bytes}, the rest embed + bf16 lm_head + norms) against "
            f"bf16 {bf16_bytes} ({bf16_bytes / 2**30:.3f} GiB); the engine "
            f"added {(torch.cuda.memory_allocated() - before) / 2**30:.2f} "
            f"GiB allocated incl. its {N_PAGES}-page KV pool")
        quantized[mode] = serve_batch(
            q_engine, f"phase {mode}",
            (gemm, "paged_kv_write", "paged_kv_write_pages",
             "paged_attention_decode", "ragged_paged_attention"), (other,),
            PHASE_ENTRIES, batch_jobs=jobs_q)
        quantized[mode]["bytes"] = q_bytes
        del q_engine
        torch.cuda.empty_cache()
        counts = bare_decode_launches(q_model)
        want = 4 * cfg.num_layers            # q/k/v, o, gate/up, down
        if counts[gemm] != want or counts[other] != 0:
            raise AssertionError(f"a bare {mode} decode_step launched {gemm} "
                                 f"{counts[gemm]} times (want {want}) and "
                                 f"{other} {counts[other]} times")
        log(f"[quant] one bare {mode} decode_step (8 lanes): {gemm} launched "
            f"{counts[gemm]} = 4 x {cfg.num_layers} times (q/k/v and gate/up "
            f"grouped); launches {counts}")
        q_models[mode] = q_model
    torch.cuda.empty_cache()
    lap("9 quantized")

    # 10. kernel path vs plain path -----------------------------------------

    def mixed_round(kcache, vcache):
        """Round 1: two chunks (300 and 200 tokens); round 2: lane 0's
        next 100-token chunk + lane 1's decode row. Returns both rounds'
        chunk logits and round 2's decode logprob."""
        tables_r = torch.zeros(2, cfg.max_pages_per_seq, dtype=torch.int32)
        tables_r[0, :30] = torch.arange(1, 31)
        tables_r[1, :20] = torch.arange(31, 51)
        g = torch.Generator().manual_seed(5)
        toks0 = torch.randint(0, 256, (500,), generator=g, dtype=torch.int32)
        toks1 = torch.randint(0, 256, (101,), generator=g, dtype=torch.int32)

        def run(tok, pos, lane, ch_rows, d_rows):
            pos = torch.tensor(pos, dtype=torch.int32)
            lane = torch.tensor(lane, dtype=torch.int32)
            pages = tables_r[lane.long(), (pos // P).long()]
            tb = tok.numel()
            z = torch.zeros(2, dtype=torch.int64)
            a = [tok, pos, pages, pos % P, torch.ones(tb, dtype=torch.bool),
                 lane, tables_r, torch.tensor(ch_rows, dtype=torch.int32),
                 torch.tensor(d_rows, dtype=torch.int32), z, z,
                 torch.zeros(2), torch.ones(2), z]
            return llama.ragged_prefill_decode(
                model, kcache, vcache, *(x.to(dev) for x in a))

        _, ch1 = run(toks0, list(range(300)) + list(range(200)),
                     [0] * 300 + [1] * 200, [299, 499], [0, 0])
        packed2, ch2 = run(toks1, list(range(300, 400)) + [200],
                           [0] * 100 + [1], [99, 99], [100, 100])
        return torch.cat([ch1, ch2]).float(), packed2[1, 0, 0].float()

    def mixed_step(mdl, kcache, vcache):
        """One mixed_prefill_decode step of `mdl` on caches holding random
        K/V:
        page-aligned chunks of 512 and 300 tokens from cursors 0 and 64
        (K3) beside 8 decode lanes at positions 40..1000 (K2, K4), 2 burst
        steps, top-8 logprobs. Returns (chunk logits (2, V), the decode
        lanes' step-0 top-8 logprobs (8, 8))."""
        g = torch.Generator().manual_seed(6)
        g_dev = torch.Generator(device=dev).manual_seed(6)
        for c in kcache + vcache:
            c.copy_(torch.randn(c.shape, generator=g_dev, device=dev))
        ch_tables = torch.zeros(2, cfg.max_pages_per_seq, dtype=torch.int32)
        ch_tables[0, :32] = torch.arange(1, 33)
        ch_tables[1, :24] = torch.arange(33, 57)
        ch_tok = torch.randint(0, 256, (2, 512), generator=g,
                               dtype=torch.int32)
        ch_cached = torch.tensor([0, 64], dtype=torch.int32)
        ch_lens = torch.tensor([512, 364], dtype=torch.int32)
        pos = torch.tensor([40, 73, 133, 233, 383, 653, 853, 1000],
                           dtype=torch.int32)
        d_tables = torch.zeros(8, cfg.max_pages_per_seq, dtype=torch.int32)
        for i in range(8):
            d_tables[i, :64] = torch.arange(57 + 64 * i, 121 + 64 * i)
        z = torch.zeros(8, dtype=torch.int64)
        a = [ch_tok, ch_tables, ch_cached, ch_lens,
             torch.randint(0, 256, (8,), generator=g, dtype=torch.int32),
             pos, d_tables, torch.ones(8, dtype=torch.bool), z, z,
             torch.zeros(8), torch.ones(8), z]
        packed, ch_logits = llama.mixed_prefill_decode(
            mdl, kcache, vcache, *(x.to(dev) for x in a), num_steps=2,
            aligned=True, topk_lp=8)
        return ch_logits.float(), packed[10:18, 0].T.float()

    with torch.inference_mode():
        caches = [llama.init_cache(cfg, 64, dev) for _ in range(2)]
        k_logits, k_lp = mixed_round(*caches[0])
        with plain_path(ragged, kernels, attention, int4_mm, torch):
            before = cuda_build.launch_counts()
            p_logits, p_lp = mixed_round(*caches[1])
            after = cuda_build.launch_counts()
        torch.cuda.synchronize()
        if before != after:
            raise AssertionError("the plain path launched a kernel")
        logit_err = (k_logits - p_logits).abs().max().item()
        log(f"[path] 8B mixed ragged round bf16: max |logit diff| "
            f"{logit_err:.4f} (|logits| max {p_logits.abs().max().item():.2f}"
            f", tolerance {LOGITS_BF16_TOL}); decode logprob diff "
            f"{abs(k_lp.item() - p_lp.item()):.4f}; greedy agree "
            f"{int((k_logits.argmax(-1) == p_logits.argmax(-1)).sum())}/4")
        if not logit_err <= LOGITS_BF16_TOL:
            raise AssertionError(f"8B logits kernel vs plain: {logit_err}")
        del caches
        for mode, mdl in (("bf16", model), *q_models.items()):
            caches = [llama.init_cache(cfg, 1 + 57 + 64 * 8, dev)
                      for _ in range(2)]
            before = cuda_build.launch_counts()
            k_ch, k_top = mixed_step(mdl, *caches[0])
            mid = cuda_build.launch_counts()
            with plain_path(ragged, kernels, attention, int4_mm, torch):
                p_ch, p_top = mixed_step(mdl, *caches[1])
                after = cuda_build.launch_counts()
            if mode != "bf16":
                # under A8 activations a bf16 ulp that K1 and the plain
                # prefill attention round apart crosses int8 steps, and
                # 32 layers carry it to the chunk logits (0.52-0.70 on an
                # H100): printed, not held; the chunk side is held with K1
                # on both sides, where K2, K3 and the A8 GEMMs must leave
                # the chunk logits bit-identical
                k1_ch = p_ch
                k1_caches = llama.init_cache(cfg, 1 + 57 + 64 * 8, dev)
                with plain_path(ragged, kernels, attention, int4_mm, torch,
                                keep_k1=True):
                    p_ch, p_top2 = mixed_step(mdl, *k1_caches)
                del k1_caches
            torch.cuda.synchronize()
            for kname in ("paged_kv_write", "paged_kv_write_pages",
                          "paged_attention_decode", "ragged_paged_attention",
                          *((GEMM_OF[mode],) if mode in GEMM_OF else ())):
                if mid[kname] == before[kname]:
                    raise AssertionError(f"the {mode} mixed step skipped "
                                         f"{kname}")
            if mid != after:
                raise AssertionError("the plain path launched a kernel")
            ch_err = (k_ch - p_ch).abs().max().item()
            top_err = (k_top - p_top).abs().max().item()
            tol = LOGITS_BF16_TOL if mode == "bf16" else LOGITS_A8_TOL
            log(f"[path] 8B mixed_prefill_decode step {mode} (chunks 512 + "
                f"300, 8 decode lanes): chunk logits max |diff| {ch_err:.4f} "
                f"(|logits| max {p_ch.abs().max().item():.2f}"
                + ("" if mode == "bf16" else
                   ", K1 on both sides; against the plain prefill attention "
                   f"{(k_ch - k1_ch).abs().max().item():.4f}, not held")
                + f"), decode top-8 logprobs max |diff| {top_err:.4f}, "
                f"tolerance {tol}; chunk greedy agree "
                f"{int((k_ch.argmax(-1) == p_ch.argmax(-1)).sum())}/2")
            if mode != "bf16" and ch_err != 0.0:
                raise AssertionError(f"8B {mode} mixed step: the chunk logits "
                                     f"with K1 on both sides differ by "
                                     f"{ch_err}")
            if not max(ch_err, top_err) <= tol:
                raise AssertionError(f"8B {mode} mixed step kernel vs plain: "
                                     f"{ch_err}, {top_err}")
            del caches
    torch.cuda.empty_cache()
    lap("10 kernel vs plain at 8B")

    # 11a + 11. graph replays and profiles ---------------------------------
    profiles = {("bf16", k): v for k, v in profile_rounds(
        torch, llama, graphs, model, dev, n_pad_mixed=768 - 520,
        labels=("decode", "mixed", "burst", "prefill1", "prefill8",
                "mixed_step", "sample_first")).items()}
    lap("11a-11 bf16 bare steps")
    # "int8" (W8A16: cuBLAS over weights converted to bf16 on every call)
    # is not a main-path cell; its burst is profiled for its step time
    # only, on a model that shares every other tensor with the bf16 one
    for mode, mdl in (*q_models.items(),
                      ("int8", quant.quantize_params(model, mode="int8"))):
        profiles[(mode, "burst")] = profile_rounds(
            torch, llama, graphs, mdl, dev, n_pad_mixed=0,
            labels=("burst",), mode=mode)["burst"]
        del mdl
    lap("11a-11 quantized bursts")
    profiles[("bf16", "spec")] = profile_spec(torch, llama, graphs, model,
                                              draft, dev)
    del draft
    lap("11a-11 spec burst")
    for (mode, label), (eager, graphed, event_ms, pool) in profiles.items():
        what = {"decode": "ragged decode round", "mixed":
                "ragged mixed round", "burst": "phase decode burst (8 "
                "steps)", "prefill1": "phase prefill chunk round (bp 1, T "
                "512)", "prefill8": "phase prefill chunk round (bp 8, T "
                "512)", "mixed_step": "phase mixed step (512-token chunk "
                "+ 8-lane 8-step burst)", "sample_first": "phase first-"
                "token sampling (8 lanes)", "spec": f"spec burst (8 lanes, "
                f"gamma {SPEC_GAMMA}, {SPEC_ITERS} iterations, 1B draft)"
                }[label] + f", {mode}"
        for how, measured in (("eager", eager), ("graphed", graphed)):
            if measured is None:
                continue        # the spec burst: replayed only
            wall_ms, busy, n_k, by_class, top = measured
            extra = (f"; the replay by CUDA events {event_ms:.2f} ms; graph "
                     f"pool {pool} bytes" if how == "graphed" else "")
            if busy is None:
                why = ("the profiler saw no device activity"
                       if n_k is not None else
                       "not profiled: cut since 8j was added"
                       if mode == "bf16" else
                       "not profiled: cut since 8k was added")
                log(f"[profile] {what}, {how}: wall {wall_ms:.2f} ms; device "
                    f"busy not measured ({why}){extra}, on {smi}")
                continue
            per_step = {"burst": f" ({n_k / 8:.0f} per step)",
                        "spec": f" ({n_k / SPEC_ITERS:.0f} per iteration)"
                        }.get(label, "")
            log(f"[profile] {what}, {how} (8B, bare): wall {wall_ms:.2f} ms "
                f"(median of 10), device busy {busy:.2f} ms, idle "
                f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%, {n_k:.0f} "
                f"device ops{per_step}{extra}, on {smi}")
            if how == "graphed" and eager is not None \
                    and eager[1] is not None:
                continue
            for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
                log(f"[profile]   {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}% "
                    f"of busy)")
            for ms, kname in top:
                log(f"[profile]   top kernel {ms:.3f} ms: {kname[:90]}")
    for label, run in (("phase", phase), ("ragged", ragged_run)):
        log(f"[profile] engine (phase 7, {label}): "
            f"{1e3 * run['wall'] / run['rounds']:.2f} ms per dispatch on "
            f"average over the batch's {run['rounds']} dispatches")
    lap("11 engine batch lines")
    shutil.rmtree(work)
    del model, q_models
    torch.cuda.empty_cache()

    # 12. kernel path vs plain path, 2 layers, fp32 ------------------------

    cfg2 = llama.LlamaConfig.llama3_8b(num_layers=2, dtype=torch.float32)
    model2 = llama.init_params(cfg2, 1, dev)

    def fp32_streams(impl, mode=None):
        eng = TorchEngine(TorchEngineConfig(
            model=cfg2, num_pages=128, max_batch_size=4,
            prefill_chunk_budget=64, attention_impl=impl, quantize=mode,
            device="cuda"), model=model2)

        async def go():
            try:
                g = torch.Generator().manual_seed(9)
                prompts = [torch.randint(0, 128256, (n,), generator=g)
                           .tolist() for n in (90, 33, 150)]
                return await asyncio.gather(
                    *(greedy_on(eng, p, 16, top=8) for p in prompts))
            finally:
                await eng.close()
        return asyncio.run(go())

    def constrained_vs_plain(mode):
        """The constrained batch (top-8 logprobs) on the phase path through
        the kernels and through the plain versions, the grammars compiled
        once in phase 8b."""
        runs = {}
        for how in ("kernels", "plain"):
            eng = TorchEngine(TorchEngineConfig(
                model=cfg2, num_pages=128, max_batch_size=8,
                prefill_chunk_budget=64, quantize=mode, device="cuda"),
                model=model2)
            seed_grammars(eng, constrained["compiled"], constrained["vocab"])

            async def go(eng=eng):
                try:
                    return await serve_requests(eng, Context,
                                                constrained_requests(top=8))
                finally:
                    await eng.close()

            ctx_swap = (plain_path(ragged, kernels, attention, int4_mm,
                                   torch, graphs) if how == "plain"
                        else contextlib.nullcontext())
            cuda_build.reset_launch_counts()
            with ctx_swap:
                runs[how] = asyncio.run(go())
            used = sorted(k for k, v in cuda_build.KERNELS.items()
                          if v.launches)
            want = {"paged_kv_write", "paged_attention_decode",
                    *((GEMM_OF[mode],) if mode else ())}
            if how == "kernels" and not want <= set(used):
                raise AssertionError(f"the 2-layer constrained {mode} run "
                                     f"launched only {used}")
            if how == "plain" and used:
                raise AssertionError(f"the plain path launched {used}")
            check_constrained(guided_mod, constrained["dfas"], runs[how],
                              f"2-layer {mode or 'fp32'} {how}")
        parts = constrained_partings(runs["kernels"], runs["plain"],
                                     BF16_TIE_TOL)
        log(f"[path] 2-layer full-width fp32 {mode or 'unquantized'} "
            f"constrained batch (8 lanes x {CONSTRAINED_MAX_TOKENS} tokens, "
            f"phase path), kernels vs plain: "
            + ("identical" if not parts else "parts at near-ties " + ", ".join(
                f"({lane}, step {i}, gap {g:.2e})" for lane, i, g in parts))
            + f" (tie tolerance {BF16_TIE_TOL})")

    for mode in (None, *QUANT_MODES):
        constrained_vs_plain(mode)
        streams = {}
        for impl in ("phase", "ragged"):
            cuda_build.reset_launch_counts()
            streams[f"{impl}-kernels"] = fp32_streams(impl, mode)
            used = sorted(k for k, v in cuda_build.KERNELS.items()
                          if v.launches)
            if mode is not None and GEMM_OF[mode] not in used:
                raise AssertionError(f"the 2-layer {mode} {impl} run never "
                                     f"launched {GEMM_OF[mode]}")
            with plain_path(ragged, kernels, attention, int4_mm, torch,
                            graphs):
                streams[f"{impl}-plain"] = fp32_streams(impl, mode)
            log(f"[path] 2-layer fp32 {mode or 'unquantized'} {impl} path, "
                f"kernels launched: {used}")
        first = streams["phase-kernels"]
        if any(len(t) != 16 for t, _ in first):
            raise AssertionError(f"fp32 {mode} streams are short: {first}")
        if mode is None:
            if any([t for t, _ in s] != [t for t, _ in first]
                   for s in streams.values()):
                raise AssertionError(f"fp32 greedy streams differ: {streams}")
            log(f"[path] 2-layer full-width fp32 unquantized: greedy streams "
                f"identical over 16 steps x {len(first)} requests across "
                f"{sorted(streams)}")
            continue
        partings = {k: stream_partings(first, s, A8_TIE_TOL)
                    for k, s in streams.items() if k != "phase-kernels"}
        log(f"[path] 2-layer full-width fp32 {mode}: greedy streams over 16 "
            f"steps x {len(first)} requests, against phase-kernels: "
            + "; ".join(f"{k} " + ("identical" if not v else
                                   "parts at near-ties " + ", ".join(
                                       f"(request {r}, step {i}, logprob "
                                       f"gap {g:.2e})" for r, i, g in v))
                        for k, v in sorted(partings.items()))
            + f" (tie tolerance {A8_TIE_TOL})")
    del model2
    torch.cuda.empty_cache()
    lap("12 kernel vs plain at 2 layers")

    # 13. numbers ------------------------------------------------------------
    # every kernel timed after a read flush (the yardstick) and, for
    # continuity with older records, after a write flush; the empty-kernel
    # floor under the same flush beside them
    flushes = l2_flushes(torch, dev)
    flush, wflush = flushes["read"], flushes["write"]
    tiny = torch.zeros(1, device=dev)
    floor = {"ms": time_ms(torch, tiny.zero_, flush=flush),
             "write": time_ms(torch, tiny.zero_, flush=wflush),
             "run": time_run_ms(torch, [tiny.zero_] * N_LAYER_RUN,
                                flush=flush)}
    log(f"[time] empty-kernel floor (1-element zero_): {floor['ms']:.4f} ms "
        f"after a read flush, {floor['write']:.4f} after a write flush, "
        f"{floor['run']:.4f} per launch in a run of {N_LAYER_RUN} on {smi}")

    def timed(fn) -> tuple[float, float]:
        """One launch of `fn`: (ms after a read flush, after a write)."""
        return (time_ms(torch, fn, flush=flush),
                time_ms(torch, fn, flush=wflush))

    # the ragged path's biggest round: a 512-token prompt chunk (the second
    # of a 1517-token prompt) + the fixed block of 8 decode rows, padded
    # to the 768-row bucket; and a decode-only round of 8 rows
    shapes = {
        "mixed": attention_mix(torch, gen, N_PAGES, P, MAX_PAGES,
                               [41, 70, 130, 230, 380, 650, 850, 1030],
                               [(512, 512)], n_pad=768 - 520),
        "decode": attention_mix(torch, gen, N_PAGES, P, MAX_PAGES,
                                [44, 73, 133, 233, 383, 653, 853, 1033],
                                [], n_pad=0),
    }
    kp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                           torch.bfloat16)
    vp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                           torch.bfloat16)
    # one (K, V) cache pair per layer for the runs of N_LAYER_RUN launches
    layer_caches = [(torch.empty_like(kp), torch.empty_like(vp))
                    for _ in range(N_LAYER_RUN)]
    # rows[key] = (rows, ms, plain_ms, bound, bound_by, library_ms,
    #              ms after a write flush, ms per launch in a run or None)
    rows = {}
    for label, (qp, ln, tb) in shapes.items():
        qp_d, ln_d, tb_d = qp.to(dev), ln.to(dev), tb.to(dev)
        q = torch.randn(qp.numel(), H, D, generator=gen).to(dev,
                                                             torch.bfloat16)
        ms, ms_w = timed(lambda: ragged.ragged_paged_attention(
            q, kp, vp, qp_d, ln_d, tb_d))
        plain_ms = time_ms(torch, lambda: plain_k1(q, kp, vp, qp_d, ln_d,
                                                   tb_d), reps=5,
                           flush=flush)
        k1_bound, by = k1_bound_ms(torch, qp, ln, tb, H, KVH, D, P, 2,
                                   peaks)
        lib1 = None
        if label == "decode":
            # one query per lane: SDPA with a padding mask computes the
            # round; the mixed round's causal chunk beside decode rows of
            # other lanes is no single SDPA call (library_ms stays null)
            # row r is lane r, attending positions <= its qpos
            sdpa = sdpa_decode(torch, attention, q, kp, vp, qp_d + 1, tb_d)
            torch.testing.assert_close(
                sdpa().float(), plain_k1(q, kp, vp, qp_d, ln_d,
                                         tb_d).float(), **K1_BF16_TOL)
            lib1 = time_ms(torch, sdpa, flush=flush)
        rows[("k1", label)] = (qp.numel(), ms, plain_ms, k1_bound, by, lib1,
                               ms_w, None)
        got = ragged.ragged_paged_attention(q, kp, vp, qp_d, ln_d, tb_d)
        want = plain_k1(q, kp, vp, qp_d, ln_d, tb_d)
        torch.testing.assert_close(got.float(), want.float(), **K1_BF16_TOL)
        if not torch.all(got[qp_d < 0] == 0):
            raise AssertionError("K1 padding rows are not exact zeros")
        err = (got.float() - want.float()).abs().max().item()
        k1_err[torch.bfloat16] = max(k1_err[torch.bfloat16], err)
        uniform_check(ragged, plain_k1, torch, kp, vp, qp_d, ln_d, tb_d, H,
                      f"{label} round at the main path's shapes")
        # K2 on the same round's rows, as the step hands them: projection
        # outputs viewed as heads, targets redirected once
        b = qp.numel()
        srcs = [(k2_rows(torch, gen, dev, b, KVH, D, "contiguous"),
                 k2_rows(torch, gen, dev, b, KVH, D, "contiguous"))
                for _ in range(N_LAYER_RUN)]
        kr, vr = srcs[0]
        pg = torch.where(qp_d >= 0, tb_d[ln_d.long(), (qp_d.clamp(min=0)
                                                     // P).long()], 0)
        of = torch.where(qp_d >= 0, qp_d % P, 0).to(torch.int32)
        pg = pg.to(torch.int32).contiguous()
        kcw, vcw = kp.clone(), vp.clone()
        kernels.paged_kv_write(kcw, vcw, kr, vr, pg, of)
        want_k, want_v = kp.clone(), vp.clone()
        kernels.paged_kv_write_ref(want_k, want_v, kr, vr, pg, of)
        if not (torch.equal(kcw[:, 1:], want_k[:, 1:])
                and torch.equal(vcw[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K2 differs from its plain version on the "
                                 f"{label} round")
        del want_k, want_v
        log(f"[check] {label} round at the main path's shapes: K1 max_abs_err "
            f"{err:.3e} ({K1_BF16_TOL}), K2 bit-exact outside "
            f"page 0")
        ms2, ms2_w = timed(lambda: kernels.paged_kv_write(
            kcw, vcw, kr, vr, pg, of))
        run2 = time_run_ms(torch, [
            (lambda c=c, s=s: kernels.paged_kv_write(*c, *s, pg, of))
            for c, s in zip(layer_caches, srcs)], flush=flush)
        plain2 = time_ms(torch, lambda: kernels.paged_kv_write_ref(
            kcw, vcw, kr, vr, pg, of), flush=flush)

        def index_put():
            kcw[:, pg.long(), of.long()] = kr.transpose(0, 1)
            vcw[:, pg.long(), of.long()] = vr.transpose(0, 1)

        lib2 = time_ms(torch, index_put, flush=flush)
        bound2, by2 = k2_bound_ms(pg, KVH, D, 2, peaks)
        rows[("k2", label)] = (b, ms2, plain2, bound2, by2, lib2, ms2_w, run2)
        del kcw, vcw, srcs, kr, vr

    # K3 at the phase path's chunk shape: a 480-token page-aligned chunk in
    # the 512 bucket = 32 slots, the last 2 padding (→ page 0); its blocks
    # the chunk's token-major K/V viewed per page, as `_chunk_kv_writer`
    # hands them
    ids3 = torch.zeros(32, dtype=torch.int32)
    ids3[:30] = 1 + torch.randperm(N_PAGES - 1, generator=gen)[:30]
    ids3_d = ids3.to(dev)
    srcs = [(k3_blocks(torch, gen, dev, 32, KVH, P, D, "chunk"),
             k3_blocks(torch, gen, dev, 32, KVH, P, D, "chunk"))
            for _ in range(N_LAYER_RUN)]
    kb3, vb3 = srcs[0]
    kcw, vcw = kp.clone(), vp.clone()
    kernels.paged_kv_write_pages(kcw, vcw, kb3, vb3, ids3_d)
    want_k, want_v = kp.clone(), vp.clone()
    kernels.paged_kv_write_pages_ref(want_k, want_v, kb3, vb3, ids3_d)
    if not (torch.equal(kcw[:, 1:], want_k[:, 1:])
            and torch.equal(vcw[:, 1:], want_v[:, 1:])):
        raise AssertionError("K3 differs from its plain version at the main "
                             "path's shape")
    del want_k, want_v
    ms3, ms3_w = timed(lambda: kernels.paged_kv_write_pages(
        kcw, vcw, kb3, vb3, ids3_d))
    run3 = time_run_ms(torch, [
        (lambda c=c, s=s: kernels.paged_kv_write_pages(*c, *s, ids3_d))
        for c, s in zip(layer_caches, srcs)], flush=flush)
    kb3c, vb3c = kb3.contiguous(), vb3.contiguous()
    ms3_c = time_ms(torch, lambda: kernels.paged_kv_write_pages(
        kcw, vcw, kb3c, vb3c, ids3_d), flush=flush)
    log(f"[time] paged_kv_write_pages chunk on contiguous blocks: "
        f"{ms3_c:.4f} ms after a read flush on {smi}")
    plain3 = time_ms(torch, lambda: kernels.paged_kv_write_pages_ref(
        kcw, vcw, kb3, vb3, ids3_d), flush=flush)
    ids3_l = ids3_d.long()

    def index_copy():
        kcw.index_copy_(1, ids3_l, kb3.transpose(0, 1))
        vcw.index_copy_(1, ids3_l, vb3.transpose(0, 1))

    lib3 = time_ms(torch, index_copy, flush=flush)
    bound3, by3 = k3_bound_ms(ids3, KVH, P, D, 2, peaks)
    rows[("k3", "chunk")] = (32, ms3, plain3, bound3, by3, lib3, ms3_w, run3)
    del kcw, vcw, srcs, kb3, vb3, kb3c, vb3c, layer_caches

    # K4 at the phase path's burst shape: 8 decode lanes, contexts 44..1033
    lens4 = [44, 73, 133, 233, 383, 653, 853, 1033]
    q4, _, _, l4, t4 = decode_case(torch, gen, dev, torch.bfloat16, lens4,
                                   N_PAGES, MAX_PAGES, H, KVH, P, D)
    ms4, ms4_w = timed(lambda: attention.paged_attention_decode(
        q4, kp, vp, l4, t4))
    plain4 = time_ms(torch, lambda: attention.paged_attention_decode_ref(
        q4, kp, vp, l4, t4), flush=flush)
    got = attention.paged_attention_decode(q4, kp, vp, l4, t4)
    want = attention.paged_attention_decode_ref(q4, kp, vp, l4, t4)
    torch.testing.assert_close(got.float(), want.float(), **K4_BF16_TOL)
    err4 = (got.float() - want.float()).abs().max().item()
    k4_err[torch.bfloat16] = max(k4_err[torch.bfloat16], err4)
    log(f"[check] burst shape: K4 max_abs_err {err4:.3e} ({K4_BF16_TOL}), "
        f"K3 bit-exact outside page 0")
    bound4, by4 = k4_bound_ms(l4.cpu(), t4.cpu(), H, KVH, D, P, 2, peaks)
    sdpa4 = sdpa_decode(torch, attention, q4, kp, vp, l4, t4)
    torch.testing.assert_close(sdpa4().float(), want.float(), **K4_BF16_TOL)
    lib4 = time_ms(torch, sdpa4, flush=flush)
    rows[("k4", "burst")] = (8, ms4, plain4, bound4, by4, lib4, ms4_w, None)

    # the draft's geometry (Llama-3.2-1B: D 64): K4 on the burst's lanes
    # and K1 on the decode round's rows, beside their plain versions and
    # SDPA on pre-gathered K/V under a padding mask
    q64, kp64, vp64, l64, t64 = decode_case(
        torch, gen, dev, torch.bfloat16, lens4, N_PAGES, MAX_PAGES, H, KVH,
        P, 64)
    want = attention.paged_attention_decode_ref(q64, kp64, vp64, l64, t64)
    torch.testing.assert_close(attention.paged_attention_decode(
        q64, kp64, vp64, l64, t64).float(), want.float(), **K4_BF16_TOL)
    ms, ms_w = timed(lambda: attention.paged_attention_decode(
        q64, kp64, vp64, l64, t64))
    plain = time_ms(torch, lambda: attention.paged_attention_decode_ref(
        q64, kp64, vp64, l64, t64), flush=flush)
    sdpa64 = sdpa_decode(torch, attention, q64, kp64, vp64, l64, t64)
    torch.testing.assert_close(sdpa64().float(), want.float(), **K4_BF16_TOL)
    rows[("k4", "burst D64")] = (
        8, ms, plain, *k4_bound_ms(l64.cpu(), t64.cpu(), H, KVH, 64, P, 2,
                                   peaks),
        time_ms(torch, sdpa64, flush=flush), ms_w, None)
    qp, ln, tb = (x.to(dev) for x in shapes["decode"])
    q1 = torch.randn(qp.numel(), H, 64, generator=gen).to(dev,
                                                          torch.bfloat16)
    want = plain_k1(q1, kp64, vp64, qp, ln, tb)
    torch.testing.assert_close(ragged.ragged_paged_attention(
        q1, kp64, vp64, qp, ln, tb).float(), want.float(), **K1_BF16_TOL)
    ms, ms_w = timed(lambda: ragged.ragged_paged_attention(
        q1, kp64, vp64, qp, ln, tb))
    plain = time_ms(torch, lambda: plain_k1(q1, kp64, vp64, qp, ln, tb),
                    reps=5, flush=flush)
    sdpa1 = sdpa_decode(torch, attention, q1, kp64, vp64, qp + 1, tb)
    torch.testing.assert_close(sdpa1().float(), want.float(), **K1_BF16_TOL)
    rows[("k1", "decode D64")] = (
        qp.numel(), ms, plain, *k1_bound_ms(
            torch, qp.cpu(), ln.cpu(), tb.cpu(), H, KVH, 64, P, 2, peaks),
        time_ms(torch, sdpa1, flush=flush), ms_w, None)
    log(f"[check] the draft's geometry (D 64): K4 on the burst's lanes and "
        f"K1 on the decode round within {K1_BF16_TOL} of their plain "
        f"versions, SDPA likewise")
    del q64, kp64, vp64, q1, want

    # K1 on the phase path's widest chunk round (phase 7b's shape: bp 8,
    # T 512, contexts to 1041); the library yardstick is
    # scaled_dot_product_attention on K/V already gathered per lane
    # (contiguous, the gather not timed) under the same causal mask
    pq = torch.randn(pf_bp, pf_t, H, D, generator=gen).to(dev,
                                                        torch.bfloat16)
    p_tags = attention.chunk_rows(pf_pos, pf_seq)
    ms_pf, ms_pf_w = timed(lambda: attention.prefill_attention(
        pq, kp, vp, pf_tables, pf_pos, pf_seq, None, p_tags))
    plain_pf = time_ms(torch, lambda: attention.prefill_attention_ref(
        pq, kp, vp, pf_tables, pf_pos, pf_seq), reps=5, flush=flush)
    n_vis = -(-max(pf_lens) // P)
    kg = attention._gather_pages(kp, pf_tables[:, :n_vis])
    vg = attention._gather_pages(vp, pf_tables[:, :n_vis])
    s_pos = torch.arange(kg.shape[2], device=dev)
    sdpa_mask = ((s_pos[None, None, :] <= pf_pos[:, :, None])
                 & (s_pos[None, None, :] < pf_seq[:, None, None]))[:, None]
    qt = pq.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=sdpa_mask, enable_gqa=True)

    lib_pf = time_ms(torch, sdpa, flush=flush)
    bnd_pf, by_pf = k1_bound_ms(torch, p_tags[0].cpu(), p_tags[1].cpu(),
                                pf_tables.cpu(), H, KVH, D, P, 2, peaks)
    rows[("k1", "prefill8")] = (pf_bp * pf_t, ms_pf, plain_pf, bnd_pf,
                                by_pf, lib_pf, ms_pf_w, None)
    del pq, kg, vg, sdpa_mask, qt

    # the KV gather of a 1041-token prompt: 66 pages of 32 layers' K and V
    # (phase 8e's pull of the longest prompt), beside the per-layer
    # index_select loop (2L calls, no stack)
    g_dev = torch.Generator(device=dev).manual_seed(14)
    gc = tuple([torch.randn(KVH, N_PAGES, P, D, generator=g_dev, device=dev,
                            dtype=torch.bfloat16)
                for _ in range(N_LAYER_RUN)] for _ in range(2))
    g_ids = (1 + torch.randperm(N_PAGES - 1, generator=gen)[:66]).to(
        torch.int32).to(dev)
    g_ptrs = kernels.cache_pointers(*gc)
    g_out = kernels.paged_kv_gather(*gc, g_ids, g_ptrs)
    if not torch.equal(g_out, kernels.paged_kv_gather_ref(*gc, g_ids)):
        raise AssertionError("the KV gather differs from its plain version "
                             "at the timed shape")
    ms_g, ms_g_w = timed(lambda: kernels.paged_kv_gather(
        *gc, g_ids, g_ptrs, out=g_out))
    plain_g = time_ms(torch, lambda: kernels.paged_kv_gather_ref(*gc, g_ids),
                      flush=flush)
    g_long = g_ids.long()
    lib_g = time_ms(torch, lambda: [c.index_select(1, g_long)
                                    for c in (*gc[0], *gc[1])], flush=flush)
    bnd_g, by_g = bound(2 * g_out.nbytes + 4 * 66, 0.0, peaks[1], peaks)
    rows[("gather", "66 pages")] = (66, ms_g, plain_g, bnd_g, by_g, lib_g,
                                    ms_g_w, None)
    log(f"[time] paged_kv_gather 66 pages x {N_LAYER_RUN} layers x K,V "
        f"({g_out.nbytes} bytes out): {g_out.nbytes / ms_g / 1e6:.1f} GB/s "
        f"read + the same written; on {smi}")
    del gc, g_out

    del kp, vp
    torch.cuda.empty_cache()

    # K5 / K6 at the four projection shapes: M = 8 (a burst's decode step)
    # and M = 512 (a prefill chunk), bf16 activations; gate/up M = 8 / 512
    # are the "burst" / "chunk" rows of the kernels line
    matmul_ms = {}
    for shape, (k8, n8) in PROJECTIONS.items():
        w_bf = torch.randn(k8, n8, generator=gen).to(dev, torch.bfloat16)
        for mode in QUANT_MODES:
            bits = quant._bits_of(mode)
            qt = quant.quantize(w_bf, bits, quant._act_bits_of(mode))
            fn, ref = a8_fns(int4_mm, mode)
            # the library's int8 GEMM takes plain int8 weights: K6's unpacked
            q8 = qt.q if bits == 8 else quant._unpack4(qt.q.T).T.contiguous()
            for m, label in ((8, "burst"), (512, "chunk")):
                x = a8_case(torch, gen, dev, m, k8, torch.bfloat16)
                got, want = fn(x, qt.q, qt.s), ref(x, qt.q, qt.s)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{GEMM_OF[mode]} {shape} M={m} "
                                         f"differs from its plain version at "
                                         f"the timed shape")
                xq, sx = int4_mm.a8_prologue_ref(x)
                # torch._int_mm takes more than 16 rows: pad to 32 with zeros
                xq_lib = xq if m > 16 else torch.cat([xq, xq.new_zeros(
                    32 - m, k8)])

                def library():
                    y = torch._int_mm(xq_lib, q8.T)
                    return ((y[:m].float() * sx) * qt.s).to(x.dtype)

                lib_same = torch.equal(library(), got)
                ms, ms_w = timed(lambda: fn(x, qt.q, qt.s))
                plain_ms = time_ms(torch, lambda: ref(x, qt.q, qt.s), reps=5,
                                   flush=flush)
                lib_ms = time_ms(torch, library, flush=flush)
                key = (mode, label if shape == "gate/up" else
                       f"{shape} {label}")
                matmul_ms[key] = time_ms(torch, lambda: x @ w_bf, flush=flush)
                bnd, by = a8_bound_ms(m, k8, n8, bits, 2, peaks)
                rows[key] = (m, ms, plain_ms, bnd, by, lib_ms, ms_w, None)
                log(f"[check] {GEMM_OF[mode]} {shape} M={m} K={k8} N={n8} "
                    f"bf16: bit-identical with its plain version; the library "
                    f"yardstick (torch._int_mm"
                    f"{' on unpacked weights' if bits == 4 else ''} + epilogue"
                    f"{', rows padded to 32' if m <= 16 else ''}) "
                    f"{'agrees bit for bit' if lib_same else 'differs'}")
            del qt, q8
        del w_bf

    for (key, label), (n, ms, plain_ms, bnd, by, lib, ms_w, run) in \
            rows.items():
        kname = GEMM_OF.get(key, key)
        extra = (f", bf16 torch.matmul {matmul_ms[(key, label)]:.4f} ms"
                 if (key, label) in matmul_ms else "")
        in_run = (f", {run:.4f} ms per launch in a run of {N_LAYER_RUN} "
                  f"(floor {floor['run']:.4f})" if run is not None else "")
        log(f"[time] {kname} {label} rows={n}: kernel {ms:.4f} ms after a "
            f"read flush (write flush {ms_w:.4f}; floor {floor['ms']:.4f})"
            f"{in_run}, plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}{extra}, bound "
            f"{bnd:.6f} ms ({by}) on {smi}")
    st = phase["steady"]
    log(f"[batch] phase path steady batch (fresh prompts of the same sizes, "
        f"graphs captured): output {st['tokens'] / st['wall']:.1f} tok/s, "
        f"TTFT p50 {statistics.median(st['ttft']) * 1e3:.1f} ms over "
        f"{len(st['ttft'])} requests, {st['rounds']} dispatches, "
        f"{st['captures']} new captures, {st['replays']} replays; on {smi}")
    for label, run in (("phase", phase), ("ragged", ragged_run),
                       *((f"phase {m}", quantized[m]) for m in QUANT_MODES)):
        ttft, g = run["ttft"], run["graphs"]
        log(f"[batch] {label} path: output {run['tokens'] / run['wall']:.1f} "
            f"tok/s, TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms (min "
            f"{min(ttft) * 1e3:.1f}, max {max(ttft) * 1e3:.1f}) over "
            f"{len(ttft)} requests, {run['rounds']} dispatches, Llama-3-8B "
            f"random weights ({label.split()[-1] if ' ' in label else 'bf16'}"
            f"), max_tokens 32; {g['captures']} graph captures in "
            f"{g['capture_s']:.3f} s, {g['replays']} replays; on {smi}")
    lap("13 numbers")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")

    def entry(kname, source, replaces, key, err, run):
        n, ms, plain_ms, bnd, by, lib, ms_w, _ = rows[key]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": run["launches"][kname],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                "ms_write_flush": ms_w}

    print(json.dumps({"kernels": [
        entry("ragged_paged_attention",
              "dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
              "dynamo_tpu/engine/ragged.py:80", ("k1", "mixed"),
              k1_err[torch.bfloat16], ragged_run),
        entry("paged_kv_write", "dynamo_tpu_torch/csrc/paged_kv_write.cu",
              "dynamo_tpu/engine/kernels.py:32", ("k2", "mixed"), k2_err,
              phase),
        entry("paged_kv_write_pages",
              "dynamo_tpu_torch/csrc/paged_kv_write_pages.cu",
              "dynamo_tpu/engine/kernels.py:78", ("k3", "chunk"), k3_err,
              phase),
        entry("paged_attention_decode",
              "dynamo_tpu_torch/csrc/paged_attention_decode.cu",
              "dynamo_tpu/engine/attention.py:226", ("k4", "burst"),
              k4_err[torch.bfloat16], phase),
        entry("w8a8_matmul", "dynamo_tpu_torch/csrc/w8a8_matmul.cu",
              "dynamo_tpu/engine/int4_mm.py:107", ("w8a8", "burst"),
              a8_err["w8a8"], quantized["w8a8"]),
        entry("int4_matmul", "dynamo_tpu_torch/csrc/int4_matmul.cu",
              "dynamo_tpu/engine/int4_mm.py:168", ("int4", "burst"),
              a8_err["int4"], quantized["int4"]),
        entry("paged_kv_gather", "dynamo_tpu_torch/csrc/paged_kv_gather.cu",
              "dynamo_tpu/engine/engine.py:72", ("gather", "66 pages"),
              gather_err, disagg),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
