"""The port's multimodal serving held against the JAX package's.

- `load_image`: the port's PNG decoder and its copy of Pillow's default
  bicubic resize give Pillow's pixels bit for bit (32x32 random PNGs
  resized to 64 and 224, as tests/test_multimodal.py makes them, larger
  images scaled down, each of the five row filters, RGBA); an image at
  the size comes back as it is; other files raise.
- `encode_image_tokens` on carried JAX weights gives the reference's
  tokens; a tie goes to the lower code (`torch.argmin` returns the first
  minimum, as `jnp.argmin`).
- A chat with an image part end to end, over one coordinator: the port's
  frontend over the reference's encode worker and the port's engine, and
  the reference's frontend over the port's encode worker and the
  reference's engine (and each frontend over the other's model): the
  same image-token run spliced into the prompt, the same bodies, and the
  same prompt again for the same image.
- Errors: no encode workers, a remote URL, a bad image.
- The port's own encoder training: deterministic, and its weights load
  and discriminate as the reference's test of a trained encoder asks.
- Prompt ids outside the vocabulary (image tokens at the default offset
  on a small model): the port's engine gives the reference's streams.
"""

import asyncio
import base64
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.models import llama as jl
from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.multimodal import encoder as tenc
from dynamo_tpu_torch.multimodal import worker as tworker
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.context import Context
from tests.test_torch_engine import ENGINE_KW, _ctx, req
from tests.test_torch_serving import (
    StoreThread,
    Tap,
    call,
    default_impl,  # noqa: F401  (fixture)
    normalized,
    same_bodies,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(image_size=64, patch_size=16, codebook_size=128)


def pil_png(seed=0, size=32, shape=None) -> bytes:
    """A random RGB PNG written by Pillow (tests/test_multimodal.py's)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 255, shape or (size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def data_url(png: bytes) -> str:
    return "data:image/png;base64," + base64.b64encode(png).decode()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filtered_png(arr: np.ndarray, filters) -> bytes:
    """An 8-bit RGB / RGBA PNG whose row y is written with filter
    `filters[y % len(filters)]` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth)."""
    h, w, c = arr.shape
    bpp, rows = c, arr.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(f)
        out.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
    ctype = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


def pil_pixels(png: bytes, size=None) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(png)).convert("RGB")
    if size is not None:
        img = img.resize((size, size))
    return np.asarray(img)


# -- load_image ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("size", [64, 224])
def test_load_image_bit_equal_to_pil(seed, size):
    png = pil_png(seed)
    cfg_t = tenc.ImageEncoderConfig(image_size=size)
    cfg_j = jenc.ImageEncoderConfig(image_size=size)
    got = tenc.load_image(data_url(png), cfg_t)
    want = jenc.load_image(data_url(png), cfg_j)
    assert got.dtype == np.float32 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    # raw base64 and bytes too, as the reference takes them
    np.testing.assert_array_equal(
        tenc.load_image(base64.b64encode(png).decode(), cfg_t), want)
    np.testing.assert_array_equal(tenc.load_image(png, cfg_t), want)


@pytest.mark.parametrize("shape", [(300, 200, 3), (97, 31, 3), (224, 1, 3),
                                   (1, 1, 3)])
def test_resize_bit_equal_to_pil_on_other_shapes(shape):
    png = pil_png(3, shape=shape)
    pixels = tenc.decode_png(png)
    np.testing.assert_array_equal(pixels, pil_pixels(png))
    for size in (224, 64, 17):
        np.testing.assert_array_equal(tenc.resize(pixels, size),
                                      pil_pixels(png, size))


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_png_row_filters_decode_like_pil(filters, channels):
    rng = np.random.RandomState(11)
    arr = rng.randint(0, 256, (23, 19, channels), dtype=np.uint8)
    # smooth regions too, where the predictors do their work
    arr[:10] = (np.arange(19)[None, :, None] * 13 % 256).astype(np.uint8)
    png = filtered_png(arr, filters)
    got = tenc.decode_png(png)
    np.testing.assert_array_equal(got, pil_pixels(png))
    np.testing.assert_array_equal(got, arr[..., :3])


def test_image_at_size_comes_back_unchanged():
    rng = np.random.RandomState(4)
    arr = rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
    png = filtered_png(arr, [4, 1])
    got = tenc.load_image(png, tenc.ImageEncoderConfig(image_size=64))
    np.testing.assert_array_equal(got, arr.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got, jenc.load_image(
        data_url(png), jenc.ImageEncoderConfig(image_size=64)))


def _bad_images() -> dict:
    from PIL import Image

    rng = np.random.RandomState(5)
    arr = rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
    gif, pal, gray = io.BytesIO(), io.BytesIO(), io.BytesIO()
    Image.fromarray(arr).save(gif, format="GIF")
    Image.fromarray(arr).convert("P").save(pal, format="PNG")
    Image.fromarray(arr[..., 0]).save(gray, format="PNG")
    good = filtered_png(arr, [0])
    return {"gif": gif.getvalue(), "palette": pal.getvalue(),
            "gray": gray.getvalue(), "truncated": good[:40],
            "garbage": b"not an image at all"}


@pytest.mark.parametrize("kind", ["gif", "palette", "gray", "truncated",
                                  "garbage"])
async def test_other_files_answer_bad_image(kind):
    data = _bad_images()[kind]
    with pytest.raises(ValueError):
        tenc.load_image(data, tenc.ImageEncoderConfig(**SMALL))
    handler = tworker.EncodeWorkerHandler(
        tenc.ImageEncoderConfig(**SMALL), device="cpu",
        params=_carried_encoder(jenc.ImageEncoderConfig(**SMALL)))
    out = [o async for o in handler.generate(
        {"image": base64.b64encode(data).decode()}, Context())]
    assert len(out) == 1 and out[0]["error"].startswith("bad image: ")
    out = [o async for o in handler.generate({}, Context())]
    assert out == [{"error": "missing 'image' (base64 or data URL)"}]


# -- the encoder --------------------------------------------------------------

def _carried_encoder(jcfg, seed=0) -> dict:
    params = jenc.init_encoder_params(jax.random.PRNGKey(seed), jcfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("geometry", ["small", "default"])
def test_encoder_tokens_equal_reference(geometry):
    kw = dict(SMALL, vocab_offset=1000) if geometry == "small" else {}
    jcfg, tcfg = jenc.ImageEncoderConfig(**kw), tenc.ImageEncoderConfig(**kw)
    assert (tcfg.num_patches, tcfg.patch_dim) == (jcfg.num_patches,
                                                  jcfg.patch_dim)
    params = _carried_encoder(jcfg, seed=2)
    jparams = jenc.init_encoder_params(jax.random.PRNGKey(2), jcfg)
    for seed in (1, 2, 9):
        img = tenc.load_image(data_url(pil_png(seed)), tcfg)
        want = np.asarray(jenc.encode_image_tokens(jparams,
                                                   jnp.asarray(img), jcfg))
        got = tenc.encode_image_tokens(params, torch.from_numpy(img), tcfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got >= tcfg.vocab_offset).all()
        assert (got < tcfg.vocab_offset + tcfg.codebook_size).all()


def test_argmin_ties_go_to_the_lower_code():
    # the property both packages rely on, stated
    assert int(torch.argmin(torch.tensor([2.0, 0.5, 0.5, 0.5]))) == 1
    assert int(jnp.argmin(jnp.asarray([2.0, 0.5, 0.5, 0.5]))) == 1
    jcfg = jenc.ImageEncoderConfig(**SMALL)
    tcfg = tenc.ImageEncoderConfig(**SMALL)
    params = _carried_encoder(jcfg, seed=3)
    img = torch.from_numpy(tenc.load_image(pil_png(4), tcfg))
    first = tenc.encode_image_tokens(params, img, tcfg)
    # a copy of every used code, placed at a higher index: each tie
    # resolves to the original
    used = sorted(set(first.tolist()))
    cb = params["codebook"].clone()
    free = [c for c in range(tcfg.codebook_size) if c not in used]
    dup = {}
    for c in used:
        hi = next(f for f in free if f > c)
        free.remove(hi)
        cb[hi] = cb[c]
        dup[c] = hi
    tied = dict(params, codebook=cb)
    got = tenc.encode_image_tokens(tied, img, tcfg)
    assert torch.equal(got, first)
    want = np.asarray(jenc.encode_image_tokens(
        {k: jnp.asarray(v.numpy()) for k, v in tied.items()},
        jnp.asarray(img.numpy()), jcfg))
    np.testing.assert_array_equal(got.numpy(), want)


# -- serving ------------------------------------------------------------------

def _weights():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


class PromptTap(Tap):
    def __init__(self, inner) -> None:
        super().__init__(inner)
        self.prompts: list[list[int]] = []

    async def generate(self, request, context):
        self.prompts.append(list(request["token_ids"]))
        async for out in super().generate(request, context):
            yield out


def _chat(model, url, text="describe this", after=None):
    parts = [{"type": "text", "text": text},
             {"type": "image_url", "image_url": {"url": url}}]
    if after:
        parts.append({"type": "text", "text": after})
    return {"model": model, "max_tokens": 5, "temperature": 0,
            "logprobs": True, "top_logprobs": 2,
            "messages": [{"role": "user", "content": parts}]}


def test_image_chat_across_packages(default_impl, monkeypatch):  # noqa: F811
    """Over one coordinator: a port engine whose card names the
    reference's encode workers, a reference engine whose card names the
    port's, both frontends. Every (frontend, model) pair answers the same
    body; each engine saw the prompt with the image's 16 tokens spliced
    between the text's bytes; the same image gives the same prompt."""
    monkeypatch.setenv("DYN_TRAIN_ENCODER", "0")
    jcfg, params, tcfg, model = _weights()
    # image ids 128..255: inside vocab 256, above the ASCII text's bytes
    offset = 128
    t_tap = PromptTap(TorchEngine(TorchEngineConfig(
        model=tcfg, device="cpu", **ENGINE_KW), model=model))
    j_tap = PromptTap(TpuEngine(TpuEngineConfig(model=jcfg, **ENGINE_KW),
                                params=params))
    ecfg = jenc.ImageEncoderConfig(**SMALL, vocab_offset=offset)
    handler = tworker.EncodeWorkerHandler(
        tenc.ImageEncoderConfig(**SMALL, vocab_offset=offset),
        device="cpu", params=_carried_encoder(ecfg))
    url, other = data_url(pil_png(7)), data_url(pil_png(8))

    async def main(store_url):
        from dynamo_tpu.multimodal import serve_encode_worker as ref_serve

        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=store_url))
        r_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=store_url))
        t_enc = await tworker.serve_encode_worker(t_rt, "dynamo", "enc-t",
                                                  handler=handler)
        r_enc = await ref_serve(r_rt, "dynamo", "enc-j", cfg=ecfg)
        t_card_ = t_card.ModelDeploymentCard(
            name="tiny-t", component="backend-t", tokenizer_kind="byte",
            context_length=64, kv_block_size=4, router_mode="round_robin",
            encode_component="enc-j")
        r_card_ = ref_card.ModelDeploymentCard(
            name="tiny-j", component="backend-j", tokenizer_kind="byte",
            context_length=64, kv_block_size=4, router_mode="round_robin",
            encode_component="enc-t")
        th = await t_entry.serve_engine(t_rt, t_tap, t_card_)
        rh = await ref_entry.serve_engine(r_rt, j_tap, r_card_)
        t_fe = await t_entry.start_frontend(t_rt, port=0)
        r_fe = await ref_entry.start_frontend(r_rt, port=0)
        try:
            for fe in (t_fe, r_fe):
                for name in ("tiny-t", "tiny-j"):
                    while not fe.manager.get(name) or not fe.manager.get(
                            name).client.instances():
                        await asyncio.sleep(0.02)
            bodies = {}
            for fe_name, fe in (("t", t_fe), ("j", r_fe)):
                for m in ("tiny-t", "tiny-j"):
                    for i, u in enumerate((url, url, other)):
                        bodies[fe_name, m, i] = await call(
                            fe.http.port, "POST", "/v1/chat/completions",
                            _chat(m, u, after="and this"))
            return bodies
        finally:
            await t_fe.stop()
            await r_fe.stop()
            await th.stop()
            await rh.stop()
            await t_enc.shutdown()
            await r_enc.shutdown()
            await t_tap.inner.close()
            await j_tap.inner.close()
            await t_rt.close()
            await r_rt.close()

    with StoreThread() as store:
        bodies = asyncio.run(asyncio.wait_for(main(store.url), 100))
    assert all(st == 200 for st, _, _ in bodies.values()), bodies
    norm = {k: (st, ct, normalized(raw)) for k, (st, ct, raw) in
            bodies.items()}
    for i in range(3):
        same_bodies([norm["t", "tiny-t", i], norm["j", "tiny-t", i],
                     norm["t", "tiny-j", i]], [norm["j", "tiny-j", i]] * 3)
    # each engine saw 6 prompts: per frontend, the image twice and another
    assert len(t_tap.prompts) == len(j_tap.prompts) == 6
    prompts = t_tap.prompts + j_tap.prompts
    text = list(b"user: describe this ")
    for p in prompts:
        img = [t for t in p if t >= offset]
        assert len(img) == 16
        assert p[:len(text)] == text
        assert p[len(text):len(text) + 16] == img
        assert bytes(p[len(text) + 16:]) == b" and this\nassistant:"
    for tap in (t_tap, j_tap):
        a, b, c, a2, b2, c2 = tap.prompts
        assert a == b == a2 == b2 and c == c2 and a != c
    assert t_tap.prompts == j_tap.prompts


async def test_image_errors_and_remote_urls():
    """No encode component on the card: a 400 naming it; a remote URL is
    refused before any encode; an undecodable image is a bad image."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols_openai import OpenAIError
    from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
    from dynamo_tpu_torch.runtime.engine import FnEngine

    calls = []

    async def enc(request, ctx):
        calls.append(request)
        yield {"image_tokens": [1]}

    msgs = [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "https://x/y.png"}}]}]
    pre = OpenAIPreprocessor(make_tokenizer("word"), "m",
                             encode_router=FnEngine(enc))
    with pytest.raises(OpenAIError, match="data:"):
        await pre._resolve_images(msgs, Context())
    assert calls == []
    none = OpenAIPreprocessor(make_tokenizer("word"), "m")
    with pytest.raises(OpenAIError, match="image inputs are not supported"):
        await none._resolve_images(msgs, Context())

    async def failing(request, ctx):
        yield {"error": "bad image: ValueError('not a PNG image')"}

    bad = OpenAIPreprocessor(make_tokenizer("word"), "m",
                             encode_router=FnEngine(failing))
    msgs[0]["content"][0]["image_url"]["url"] = "data:image/png;base64,AA=="
    with pytest.raises(OpenAIError, match="image encode failed: bad image"):
        await bad._resolve_images(msgs, Context())
    # text-only list content passes through without any encode
    text_only = [{"role": "user", "content": [{"type": "text",
                                               "text": "hi"}]}]
    out, toks = await pre._resolve_images(text_only, Context())
    assert out == text_only and toks == {} and calls == []


def test_frontend_without_encode_workers_answers_400(default_impl):  # noqa: F811
    jcfg, params, tcfg, model = _weights()
    eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                        **ENGINE_KW), model=model)

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        card = t_card.ModelDeploymentCard(
            name="tiny-t", tokenizer_kind="byte", context_length=64,
            kv_block_size=4, router_mode="round_robin")
        h = await t_entry.serve_engine(rt, eng, card)
        fe = await t_entry.start_frontend(rt, port=0)
        try:
            while not fe.manager.get("tiny-t"):
                await asyncio.sleep(0.02)
            return [await call(fe.http.port, "POST", "/v1/chat/completions",
                               _chat("tiny-t", u))
                    for u in (data_url(pil_png(1)), "https://x/y.png")]
        finally:
            await fe.stop()
            await h.stop()
            await eng.close()
            await rt.close()

    (s1, _, b1), (s2, _, b2) = asyncio.run(asyncio.wait_for(main(), 60))
    assert s1 == 400 and b"image inputs are not supported" in b1
    assert s2 == 400 and b"image inputs are not supported" in b2


def test_encode_worker_cli_serves(tmp_path):
    """`python -m dynamo_tpu_torch.worker --encode-worker` boots on the CPU
    and registers the encode endpoint under the `encoder` component."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, DYN_TRAIN_ENCODER="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.worker", "--encode-worker",
         "--store", "memory", "--device", "cpu", "--image-vocab-offset",
         "500"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        line = proc.stdout.readline().decode()
        assert line.startswith("WORKER_READY dynamo/encoder/encode/"), (
            line, proc.stderr.read(3000) if proc.poll() is not None else "")
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- the port's training ------------------------------------------------------

def test_training_is_deterministic():
    from dynamo_tpu_torch.multimodal.train_encoder import train

    a, la = train(n_images=25, steps=3)
    b, lb = train(n_images=25, steps=3)
    assert la == lb
    assert sorted(a) == ["codebook", "dec", "proj"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_trained_encoder_loads_and_discriminates():
    """The reference's test of its trained encoder
    (tests/test_multimodal.py), on the port's weights (trained at first
    use on the CPU when the file is absent)."""
    cfg = tenc.ImageEncoderConfig()
    params = tenc.load_trained_encoder(cfg)
    assert params is not None
    s = cfg.image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    grad = np.stack([xx, yy, 1 - xx], axis=-1)
    checker = np.zeros((s, s, 3), np.float32)
    checker[((np.mgrid[0:s][..., None] // 16
              + np.mgrid[0:s][None] // 16) % 2) == 1] = 1.0
    flat = np.full((s, s, 3), 0.4, np.float32)

    def tokens(img):
        return tenc.encode_image_tokens(params, torch.from_numpy(img),
                                        cfg).numpy()

    t_grad, t_check, t_flat = tokens(grad), tokens(checker), tokens(flat)
    np.testing.assert_array_equal(t_grad, tokens(grad))     # stable
    assert (t_grad != t_check).mean() > 0.3                 # distinct
    assert len(set(t_flat.tolist())) <= 4
    assert len(set(t_grad.tolist())) > 16

    def vq_err(p):
        n, ps = s // cfg.patch_size, cfg.patch_size
        x = grad.reshape(n, ps, n, ps, 3).transpose(0, 2, 1, 3, 4)
        x = x.reshape(-1, cfg.patch_dim)
        x = x - x.mean(axis=-1, keepdims=True)
        z = x @ p["proj"].numpy()
        cb = p["codebook"].numpy()
        d = (cb ** 2).sum(-1)[None] - 2 * z @ cb.T
        q = cb[d.argmin(-1)]
        return float(((z - q) ** 2).mean())

    rnd = tenc.init_encoder_params(torch.Generator().manual_seed(0), cfg)
    assert vq_err(params) < 0.25 * vq_err(rnd)


# -- prompt ids outside the vocabulary ----------------------------------------

def test_embedding_index_matches_reference_gather():
    jcfg, params, tcfg, model = _weights()
    ids = np.array([[0, 5, 255, 256, 300, 128256, 30123, -1, -5, -300]],
                   np.int32)
    want = np.asarray(jax.jit(lambda e, t: e[t])(params["embed"],
                                                 jnp.asarray(ids)))
    got = tl.embed_rows(model, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["phase", "ragged"])
async def test_out_of_range_prompt_ids_match_reference(impl):
    """Image tokens at the encode worker's default offset (128256) on a
    vocabulary of 256, beside text: the reference's jitted embedding
    gather clamps them, its penalty histogram folds them (% vocab); the
    port's streams, logprobs included, are the reference's."""
    from dynamo_tpu.engine import attention as jattn

    prev = jattn._impl
    jattn.set_attention_impl("auto" if impl == "phase" else "ragged")
    jcfg, params, tcfg, model = _weights()
    j_eng = TpuEngine(TpuEngineConfig(model=jcfg, **ENGINE_KW),
                      params=params)
    t_eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                          attention_impl=impl, **ENGINE_KW),
                        model=model)
    image = [128256 + c for c in (3, 900, 17, 17, 1023, 0)]
    reqs = [req([5, 6, 7] + image + [8, 9], 6),
            req(image + [300, 70000, 255], 6),
            dict(req([11, 12] + image, 6), sampling={
                "temperature": 0.0, "top_logprobs": 3,
                "presence_penalty": 0.7, "repetition_penalty": 1.3})]

    async def run(eng):
        out = []
        for r in reqs:
            toks, tops = [], []
            async for o in eng.generate(dict(r), _ctx(eng)):
                toks.extend(o.get("token_ids") or ())
                tops.extend(o.get("top_logprobs") or ())
            out.append((toks, tops))
        return out

    try:
        want = await run(j_eng)
        got = await run(t_eng)
    finally:
        await j_eng.close()
        await t_eng.close()
        jattn.set_attention_impl(prev)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt and len(gt) == 6
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([v for _, v in a], [v for _, v in b],
                                       atol=1e-5)
