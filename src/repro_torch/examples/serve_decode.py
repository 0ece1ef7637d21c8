"""Serve a small model: batched prefill + greedy decode with KV cache: the
twin of ``examples/serve_decode.py`` on the port, its flags and its printed
lines.  The REDUCED config of ``--arch`` in float32, as the JAX example
runs it; its weights from ``model.init_params``' seeded
``torch.Generator`` (the JAX PRNG is not reproduced).  The prefill runs
``model.prefill``, whose self-attention launches the float32 flash kernel
on the card; the decode ``launch.steps.make_serve_step``.

Run: python -m repro_torch.examples.serve_decode --arch gemma2-2b --tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import model


def example_inputs(cfg, batch: int, prompt_len: int, device, seed: int = 1) -> dict:
    """Prompt tokens in [1, vocab) (and whisper's frames, internvl2's vision
    embeddings, standard normal) from a ``torch.Generator`` seeded with
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    batch_ = {"tokens": torch.randint(1, cfg.vocab, (batch, prompt_len), generator=g,
                                      device=device, dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch_["frames"] = torch.randn((batch, cfg.encoder_frames, cfg.d_model), generator=g,
                                       device=device)
    if cfg.n_vision_tokens:
        batch_["vision_embeds"] = torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                              generator=g, device=device)
    return batch_


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def decode(params, cfg, batch: dict, tokens: int, plain_attention: bool = False) -> dict:
    """Prefill ``batch`` into a cache of prompt + ``tokens`` positions, then
    ``tokens`` - 1 greedy decode steps: {"tokens" [B, tokens] (int32),
    "logits" [tokens, B, V] (each step's logits, float32),
    "prefill_s", "decode_ms"}.  ``plain_attention``: the prefill's
    self-attention through the kernel's plain version (the reference)."""
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    serve_step = steps.make_serve_step(cfg)
    with torch.no_grad():
        t0 = time.time()
        logits, cache = model.prefill(params, cfg, batch, S + tokens,
                                      plain_attention=plain_attention)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        _sync(dev)
        prefill_s = time.time() - t0
        outs, steps_logits = [tok], [logits]
        t0 = time.time()
        for _ in range(tokens - 1):
            tok, logits, cache = serve_step(params, tok, cache)
            outs.append(tok)
            steps_logits.append(logits)
        _sync(dev)
        dt = time.time() - t0
    return {"tokens": torch.cat(outs, dim=1), "logits": torch.stack(steps_logits).float(),
            "prefill_s": prefill_s, "decode_ms": dt / max(tokens - 1, 1) * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=True).replace(dtype="float32")
    params = model.init_params(cfg, 0, device=dev)
    B, S = args.batch, args.prompt_len
    batch = example_inputs(cfg, B, S, dev)
    run = decode(params, cfg, batch, args.tokens)
    print(f"prefill[{B}x{S}] {run['prefill_s']:.2f}s")
    print(f"decoded {args.tokens} tokens/seq: {run['decode_ms']:.1f} ms/step")
    print("sample token ids:", run["tokens"][0, :16].tolist())
    return {"cfg": cfg, "params": params, "batch": batch, **run}


if __name__ == "__main__":
    main()
