"""HTTP serving for μ² report generation (counterpart of
``u2tokenizer_tpu/serve.py``): a server on the standard library's
``http.server`` exposing

  POST /v1/report            {"image_path" | "volume_id", "question",
                              "stream"?} -> {"report", "latency_s"}, or
                              server-sent events of {"report_delta"}
  POST /v1/upload            raw .nii/.nii.gz/.npy bytes (X-Filename)
                              -> {"volume_id", "chunks", "depth", ...}
  POST /v1/chat/completions  OpenAI protocol, text only ("n", "stream")
  POST /v1/completions       OpenAI protocol, text only
  GET  /health, /, /v1/models, /v1/config,
       /v1/volume/<id>/slice/<index> (a grayscale PNG)

Volumes are referenced by server-visible path (NIfTI or preprocessed
.npy) or by the id of an upload, and ingested by
``data.transforms.U2VolumeTransform`` on the model's device. Reports are
generated one at a time under a lock, unless the model is ``concurrent``
(``models.slot_serving.EngineInference``, whose requests share a pool of
decode slots). ``TextLMServer`` serves a bare decoder over the OpenAI
protocol (a synthesis LLM or a GREEN judge). Every handler thread runs
under ``torch.inference_mode`` (grad mode is a per-thread setting).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .config import GenerationConfig
from .models.generate import make_fanout_generate_fn, make_generate_fn
from .models.speculative import make_spec_generate_fn
from .models.u2_model import resolve_model_device
from .utils.png import encode_png


def encode_gray_png(img) -> bytes:
    """8-bit grayscale PNG of a 2-D array or tensor, min-max scaled: the
    web page's slice viewer."""
    if torch.is_tensor(img):
        img = img.detach().float().cpu().numpy()
    arr = np.asarray(img, np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    return encode_png(((arr - lo) / (hi - lo + 1e-8) * 255.0).astype(
        np.uint8))


class U2Server:
    def __init__(self, inference_model, transform=None):
        """inference_model: ``eval.inference.U2InferenceModel``,
        ``slot_serving.EngineInference`` or any object with
        ``.inference(image, question)``. transform: path -> (T, D, H, W)
        volume; defaults to the validation ``U2VolumeTransform`` at the
        model's geometry on the model's device; ``False`` for a text-only
        server (``TextLMServer``) with no volume ingestion."""
        self.model = inference_model
        if transform is None:
            from .data.transforms import U2VolumeTransform

            cfg = inference_model.cfg
            transform = U2VolumeTransform(
                data_type="validation",
                target_size=cfg.vision.input_spatial[1],
                chunk_depth=cfg.vision.input_spatial[0],
                num_chunks=cfg.num_chunks,
                device=getattr(inference_model, "device", "cuda"))
        self.transform = transform
        self._lock = threading.Lock()
        # uploaded-volume store: id -> volume
        self._volumes: dict = {}
        self._volume_order: list = []
        self.max_cached_volumes = 8

    def load_volume(self, path: str):
        if path in self._volumes:
            return self._volumes[path]
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        return self.transform(path)

    def upload_volume(self, data: bytes, filename: str) -> dict:
        """Ingest raw upload bytes (.nii/.nii.gz/.npy), preprocess through
        the transform, keep under a volume id."""
        import hashlib
        import os
        import tempfile

        suffix = ".npy" if filename.endswith(".npy") else (
            ".nii.gz" if filename.endswith(".nii.gz") else ".nii")
        fd, tmp = tempfile.mkstemp(suffix=suffix)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            if suffix == ".npy":
                volume = np.load(tmp).astype(np.float32)
            else:
                volume = self.transform(tmp)
        finally:
            os.unlink(tmp)
        vid = "vol-" + hashlib.sha1(data).hexdigest()[:12]
        if vid not in self._volumes:
            self._volumes[vid] = volume
            self._volume_order.append(vid)
            while len(self._volume_order) > self.max_cached_volumes:
                self._volumes.pop(self._volume_order.pop(0), None)
        t, d, h, w = volume.shape
        return {"volume_id": vid, "chunks": t, "depth": d,
                "height": h, "width": w}

    def slice_png(self, volume_id: str, index: int) -> bytes:
        """Global slice index across chunks -> grayscale PNG."""
        vol = self._volumes.get(volume_id)
        if vol is None:
            raise FileNotFoundError(f"unknown volume {volume_id}")
        t, d, _, _ = vol.shape
        index = max(0, min(int(index), t * d - 1))
        return encode_gray_png(vol[index // d, index % d])

    def report(self, image_path: str, question: str) -> str:
        volume = self.load_volume(image_path)
        if getattr(self.model, "concurrent", False):
            # continuous-batching engine: requests share the slot pool,
            # no global serialization (models/slot_serving.EngineInference)
            return self.model.inference(volume, question)
        with self._lock:  # one generation at a time on the device
            return self.model.inference(volume, question)

    def chat(self, messages) -> str:
        prompt = "\n".join(m.get("content", "") for m in messages)
        infer = (self.model.text_completion if hasattr(
            self.model, "text_completion")
            else lambda p: self.model.inference(None, p))
        if getattr(self.model, "concurrent", False):
            return infer(prompt)
        with self._lock:
            return infer(prompt)

    # -- streaming ------------------------------------------------------

    def _stream(self, image, question: str):
        """Yield text deltas. True token streaming needs the slot engine
        (``EngineInference.inference_stream``); other backends send one
        final chunk, still valid SSE."""
        if hasattr(self.model, "inference_stream"):
            yield from self.model.inference_stream(image, question)
            return
        if image is None:
            yield self.chat([{"role": "user", "content": question}])
        else:
            if getattr(self.model, "concurrent", False):
                yield self.model.inference(image, question)
            else:
                # compute under the lock, yield after releasing it: holding
                # the lock across the yield would let one slow SSE consumer
                # block every other request
                with self._lock:
                    text = self.model.inference(image, question)
                yield text

    def chat_n(self, messages, n: int):
        """n choices for one prompt (OpenAI ``n``). Backends with
        ``text_completion_n`` (``TextLMServer``) decode all sampled choices
        in one call against the shared prompt cache; others loop."""
        if n > 1 and hasattr(self.model, "text_completion_n"):
            prompt = "\n".join(m.get("content", "") for m in messages)
            return self.model.text_completion_n(prompt, n)
        return [self.chat(messages) for _ in range(max(n, 1))]

    def chat_stream(self, messages):
        prompt = "\n".join(m.get("content", "") for m in messages)
        yield from self._stream(None, prompt)

    def report_stream(self, image_path: str, question: str):
        volume = self.load_volume(image_path)
        yield from self._stream(volume, question)


class TextLMServer:
    """OpenAI-protocol text serving of a bare decoder (``CausalLM``, say a
    synthesis LLM or a GREEN judge) on ``device`` (the GPU unless the
    caller names another), where the model must lie; the model carries
    its weights (the JAX package's ``params`` argument is gone).

    Greedy serving decodes speculatively by default (the same tokens;
    n-gram drafts pay on template-heavy completions); ``speculative=True``
    with ``do_sample`` takes the distribution-preserving sampled variant.
    Each call draws from a generator seeded with the server's call count.
    ``spec_stats`` counts emitted tokens (after the first) and verify
    steps."""

    def __init__(self, model, tokenizer, max_new_tokens: int = 512,
                 do_sample: bool = False, top_p: float = 0.9,
                 temperature: float = 1.0, max_length: int = 2048,
                 name: str = "u2-llm", speculative: Optional[bool] = None,
                 device="cuda"):
        self.device = resolve_model_device(model, device)
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.name = name
        self.cfg = getattr(model, "cfg", None)
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, top_p=top_p,
            temperature=temperature,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or 0)
        self._speculative = (not do_sample) if speculative is None \
            else speculative
        if self._speculative:
            self._gen = make_spec_generate_fn(model, self.gen_cfg,
                                              return_stats=True)
        else:
            self._gen = make_generate_fn(model, self.gen_cfg)
        self._lock = threading.Lock()
        self._calls = 0
        self._fan_cache = {}  # n -> fan-out generate (OpenAI `n`)
        # acceptance telemetry (speculative only; surfaced via /v1/config):
        # mean acceptance = emitted_tokens / verify_steps
        self.spec_stats = {"emitted_tokens": 0, "verify_steps": 0}

    def _encode_prompt(self, prompt: str):
        """Tokenize + right-pad one prompt: (1, max_length) ids, length."""
        ids = self.tokenizer(prompt)["input_ids"][: self.max_length]
        arr = np.full((1, self.max_length), self.gen_cfg.pad_token_id,
                      np.int64)
        arr[0, : len(ids)] = ids
        return arr, len(ids)

    def _decode_row(self, row) -> str:
        return self.tokenizer.decode(
            [t for t in row if t != self.gen_cfg.pad_token_id],
            skip_special_tokens=True)

    def _inputs(self, arr, n_ids: int):
        """(ids, embeds, lens, generator) on the device for one call."""
        self._calls += 1
        ids = torch.from_numpy(arr).to(self.device)
        lens = torch.tensor([n_ids], dtype=torch.int32, device=self.device)
        generator = torch.Generator(self.device).manual_seed(self._calls)
        return ids, self.model.embed_tokens(ids), lens, generator

    @torch.inference_mode()
    def text_completion(self, prompt: str) -> str:
        arr, n_ids = self._encode_prompt(prompt)
        with self._lock:
            ids, embeds, lens, generator = self._inputs(arr, n_ids)
            if self._speculative:
                toks, steps = self._gen(embeds, ids, lens, generator)
                toks = toks.cpu().numpy()
                eos_id = self.gen_cfg.eos_token_id
                eos = (np.nonzero(toks[0] == eos_id)[0]
                       if eos_id is not None else np.empty(0, np.int64))
                emitted = int(eos[0]) + 1 if eos.size else toks.shape[1]
                # tok0 comes from the prefill, not a verify step
                self.spec_stats["emitted_tokens"] += max(emitted - 1, 0)
                self.spec_stats["verify_steps"] += int(steps)
            else:
                toks = self._gen(embeds, lens, generator).cpu().numpy()
        return self._decode_row(toks[0])

    @torch.inference_mode()
    def text_completion_n(self, prompt: str, n: int):
        """n choices for one prompt (OpenAI ``n``). A sampled server
        decodes all n rows in one call against the shared prompt cache
        (``generate.make_fanout_generate_fn``: the prompt prefilled once,
        the exact output distribution). A greedy server returns n copies
        of its one completion."""
        if n <= 1 or not self.gen_cfg.do_sample:
            return [self.text_completion(prompt)] * max(n, 1)
        if n not in self._fan_cache:
            self._fan_cache[n] = make_fanout_generate_fn(self.model,
                                                         self.gen_cfg, n)
        arr, n_ids = self._encode_prompt(prompt)
        with self._lock:
            _, embeds, lens, generator = self._inputs(arr, n_ids)
            toks = self._fan_cache[n](embeds, lens, generator).cpu().numpy()
        return [self._decode_row(row) for row in toks]

    # U2Server-compatible surface (chat endpoint)
    def inference(self, image, question: str) -> str:
        return self.text_completion(question)


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>μ² report demo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:860px;margin:2rem auto;
      padding:0 1rem;background:#fafafa;color:#222}
 h1{font-size:1.3rem} textarea,input[type=text]{width:100%;
      box-sizing:border-box;font:inherit;padding:.5rem;margin:.25rem 0;
      border:1px solid #bbb;border-radius:6px}
 button{padding:.5rem 1.2rem;border:0;border-radius:6px;background:#2563eb;
      color:#fff;font:inherit;cursor:pointer} button:disabled{opacity:.5}
 pre{white-space:pre-wrap;background:#fff;border:1px solid #ddd;
      border-radius:6px;padding:1rem;min-height:4rem}
 .hint{color:#666;font-size:.85rem} .row{display:flex;gap:1rem}
 .col{flex:1} #slice{width:100%;image-rendering:pixelated;background:#000;
      border-radius:6px;min-height:120px}
 #cfg{font-size:.8rem;color:#444;background:#eef;border-radius:6px;
      padding:.3rem .6rem;display:inline-block}
 input[type=range]{width:100%}
</style></head><body>
<h1>μ² radiology report demo</h1>
<div id="cfg">loading config…</div>
<p class="hint">Upload a CT volume (.nii / .nii.gz / preprocessed .npy) or
give a server-visible path; leave both empty for a text-only chat turn
(src/demo/online_demo.py counterpart: upload + slice viewer + load-option
readout).</p>
<div class="row">
 <div class="col">
  <input type="file" id="file" accept=".nii,.gz,.npy">
  <button onclick="upload()" id="up">Upload &amp; preprocess</button>
  <div class="hint" id="upinfo">no volume uploaded</div>
  <input id="image" type="text"
         placeholder="...or /server/path/volume.nii.gz">
 </div>
 <div class="col">
  <img id="slice" alt="slice viewer">
  <input type="range" id="slider" min="0" max="0" value="0"
         oninput="showSlice()" disabled>
  <div class="hint" id="sliceinfo">slice —</div>
 </div>
</div>
<textarea id="question" rows="3">Please provide a detailed caption outlining
the findings of this image.</textarea>
<button id="go" onclick="run()">Generate</button>
<pre id="out">—</pre>
<script>
let volumeId=null, nSlices=0;
fetch('/v1/config').then(r=>r.json()).then(c=>{
  document.getElementById('cfg').textContent=
    'weights: '+c.weights+' · speculative: '+c.speculative+
    ' · continuous batching: '+c.concurrent;
}).catch(()=>{});
async function upload(){
  const f=document.getElementById('file').files[0];
  const info=document.getElementById('upinfo');
  if(!f){info.textContent='choose a file first';return}
  info.textContent='uploading + preprocessing…';
  try{
    const resp=await fetch('/v1/upload',{method:'POST',
      headers:{'X-Filename':f.name,
               'Content-Type':'application/octet-stream'},
      body:await f.arrayBuffer()});
    const j=await resp.json();
    if(j.error){info.textContent='error: '+j.error;return}
    volumeId=j.volume_id; nSlices=j.chunks*j.depth;
    info.textContent=j.volume_id+' — '+j.chunks+'×'+j.depth+'×'+
      j.height+'×'+j.width;
    const s=document.getElementById('slider');
    s.max=nSlices-1; s.value=Math.floor(nSlices/2); s.disabled=false;
    showSlice();
  }catch(e){info.textContent='error: '+e}
}
function showSlice(){
  if(!volumeId)return;
  const i=document.getElementById('slider').value;
  document.getElementById('slice').src='/v1/volume/'+volumeId+'/slice/'+i;
  document.getElementById('sliceinfo').textContent=
    'slice '+i+' / '+(nSlices-1);
}
async function run(){
  const btn=document.getElementById('go'); btn.disabled=true;
  const out=document.getElementById('out'); out.textContent='generating…';
  const image=document.getElementById('image').value.trim();
  const question=document.getElementById('question').value;
  try{
    let resp;
    if(volumeId||image){
      const body=volumeId?{volume_id:volumeId,question}
                         :{image_path:image,question};
      resp=await fetch('/v1/report',{method:'POST',
        headers:{'Content-Type':'application/json'},
        body:JSON.stringify(body)});
      const j=await resp.json();
      out.textContent=j.report||JSON.stringify(j);
    }else{
      resp=await fetch('/v1/chat/completions',{method:'POST',
        headers:{'Content-Type':'application/json'},
        body:JSON.stringify({messages:[{role:'user',content:question}]})});
      const j=await resp.json();
      out.textContent=(j.choices&&j.choices[0].message.content)||JSON.stringify(j);
    }
  }catch(e){out.textContent='error: '+e}
  btn.disabled=false;
}
</script></body></html>"""


# OpenAI `n` upper bound: each distinct n keeps an n-row fan-out decode,
# so n must be small and bounded (16: pred_then_green's 8 with headroom)
MAX_N_CHOICES = 16


def make_handler(server: U2Server):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_sse(self, chunks, wrap):
            """OpenAI-style server-sent events: one `data: {json}` line per
            delta, closed with `data: [DONE]`. ``wrap(delta)`` builds the
            per-chunk payload."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for delta in chunks:
                    data = json.dumps(wrap(delta)).encode()
                    self.wfile.write(b"data: " + data + b"\n\n")
                    self.wfile.flush()
            except Exception as e:  # noqa: BLE001 — headers already sent:
                # surface the error as an SSE event instead of dying silently;
                # if the socket itself is what failed (client disconnect mid-
                # stream), these writes raise again — swallow that and just
                # end the stream quietly.
                try:
                    err = json.dumps({"error": f"{type(e).__name__}: {e}"})
                    self.wfile.write(b"data: " + err.encode() + b"\n\n")
                except OSError:
                    return
            try:
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:
                pass

        def log_message(self, fmt, *args):  # quiet
            pass

        def _parse_n(self, req) -> Optional[int]:
            """OpenAI ``n``, bounded: each distinct n keeps a fan-out
            decode in the server's cache and decodes n rows at once, so an
            unbounded n would exhaust memory; reply 400 and return None
            instead."""
            n = max(int(req.get("n") or 1), 1)
            if n > MAX_N_CHOICES:
                self._send(400,
                           {"error": f"n > {MAX_N_CHOICES} unsupported"})
                return None
            return n

        @torch.inference_mode()
        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path in ("/", "/index.html"):
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                name = getattr(server.model, "name", "u2")
                self._send(200, {"object": "list",
                                 "data": [{"id": name, "object": "model"}]})
            elif self.path == "/v1/config":
                # load-option introspection: precision is fixed at launch,
                # so the page reports it instead of switching live
                m = server.model
                payload = {
                    "weights": getattr(m, "weights", "bf16"),
                    "speculative": bool(getattr(m, "_speculative",
                                                getattr(m, "speculative",
                                                        False))),
                    "concurrent": bool(getattr(m, "concurrent", False)),
                    "max_new_tokens": getattr(
                        getattr(m, "gen_cfg", None), "max_new_tokens", None),
                }
                stats = getattr(m, "spec_stats", None)
                if payload["speculative"] and stats and \
                        stats.get("verify_steps"):
                    payload["spec_stats"] = dict(
                        stats, mean_accept_per_step=round(
                            stats["emitted_tokens"]
                            / stats["verify_steps"], 2))
                mode = getattr(m, "spec_mode", None)
                if payload["speculative"] and mode is not None:
                    payload["spec_mode"] = mode
                    kb = getattr(m, "spec_block_len", None)
                    if kb is not None:
                        payload["spec_block_len"] = kb
                tele = getattr(m, "telemetry", None)
                if isinstance(tele, dict):  # slot engine live stats
                    payload["engine"] = tele
                self._send(200, payload)
            elif self.path.startswith("/v1/volume/"):
                # /v1/volume/<id>/slice/<index> -> PNG
                parts = self.path.strip("/").split("/")
                try:
                    vid, idx = parts[2], int(parts[4])
                    png = server.slice_png(vid, idx)
                except (IndexError, ValueError):
                    self._send(400, {"error": "bad slice path"})
                    return
                except FileNotFoundError as e:
                    self._send(404, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            else:
                self._send(404, {"error": "not found"})

        @torch.inference_mode()
        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            if self.path == "/v1/upload":
                # raw volume bytes; filename via X-Filename header
                try:
                    data = self.rfile.read(length)
                    info = server.upload_volume(
                        data, self.headers.get("X-Filename", "volume.nii.gz"))
                    self._send(200, info)
                except Exception as e:  # noqa: BLE001 — surface to client
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid JSON"})
                return
            t0 = time.time()
            try:
                stream = bool(req.get("stream"))
                if self.path == "/v1/report":
                    if "volume_id" in req:  # uploaded volume
                        req = dict(req, image_path=req["volume_id"])
                    if "image_path" not in req or "question" not in req:
                        self._send(400, {"error":
                                         "image_path and question required"})
                        return
                    if stream:
                        self._send_sse(
                            server.report_stream(req["image_path"],
                                                 req["question"]),
                            lambda d: {"report_delta": d})
                        return
                    text = server.report(req["image_path"], req["question"])
                    self._send(200, {"report": text,
                                     "latency_s": round(time.time() - t0, 3)})
                elif self.path == "/v1/chat/completions":
                    n = self._parse_n(req)
                    if n is None:
                        return
                    if stream:
                        if n > 1:
                            self._send(400, {"error":
                                             "stream with n>1 unsupported"})
                            return
                        self._send_sse(
                            server.chat_stream(req.get("messages", [])),
                            lambda d: {"choices": [{
                                "delta": {"content": d}, "index": 0,
                                "finish_reason": None}]})
                        return
                    texts = server.chat_n(req.get("messages", []), n)
                    self._send(200, {
                        "choices": [{"index": i,
                                     "message": {"role": "assistant",
                                                 "content": t},
                                     "finish_reason": "stop"}
                                    for i, t in enumerate(texts)],
                    })
                elif self.path == "/v1/completions":
                    msgs = [{"role": "user", "content": req.get("prompt", "")}]
                    n = self._parse_n(req)
                    if n is None:
                        return
                    if stream:
                        if n > 1:
                            self._send(400, {"error":
                                             "stream with n>1 unsupported"})
                            return
                        self._send_sse(
                            server.chat_stream(msgs),
                            lambda d: {"choices": [{"text": d, "index": 0,
                                                    "finish_reason": None}]})
                        return
                    texts = server.chat_n(msgs, n)
                    self._send(200, {
                        "choices": [{"text": t, "index": i,
                                     "finish_reason": "stop"}
                                    for i, t in enumerate(texts)],
                    })
                else:
                    self._send(404, {"error": "not found"})
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:  # bad request (e.g. volume shape)
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface to client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # clients of the slot pool connect in bursts (every slot's request,
    # streams beside them, telemetry polls): a listen backlog of 128, not
    # socketserver's 5, so that the kernel drops none of their connections
    request_queue_size = 128


def serve(inference_model, host: str = "0.0.0.0", port: int = 8088,
          transform=None) -> ThreadingHTTPServer:
    """Start the server (blocking)."""
    srv = U2Server(inference_model, transform)
    httpd = _HTTPServer((host, port), make_handler(srv))
    httpd.serve_forever()
    return httpd


def serve_background(inference_model, host: str = "127.0.0.1",
                     port: int = 8088, transform=None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (``port=0``
    takes a free port: ``httpd.server_address[1]``); ``httpd.shutdown()``
    stops it."""
    srv = U2Server(inference_model, transform)
    httpd = _HTTPServer((host, port), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
