"""Interactive EILeV chat: interleave videos and text, generate narrations
(counterpart of ``demo/eilev_demo.py``).

Each turn rebuilds the full interleaved prompt and, by default, beam-searches
it (5 beams, length_penalty -1, the OPT newline eos; videos capped at 8 s / 8
frames), as the original demo does. ``--kv_reuse`` serves greedy turns over a
persistent ``ChatSession`` (only each turn's new tokens and videos are
prefilled); ``--engine`` serves them through a persistent
``ContinuousBatchingEngine`` whose ``video_bucket`` encodes every turn's
videos in fixed buckets. Runs on ``--device`` (the card by default).

    python -m eilev_tpu_torch.demo.eilev_demo --model DIR [--kv_reuse | --engine] [--terminal [--stream]]

Runs as a Gradio app when gradio is installed; otherwise as a terminal chat
(type a message, or ``/video <path>`` to add a clip, ``/reset`` to clear).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

MAX_CLIP_SECONDS = 8
NUM_FRAMES = 8
MAX_NEW_TOKENS = 32
OPT_NEWLINE = 50118  # the OPT newline eos (LAVIS convention)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


class EilevChat:
    """Interleaved chat state and generation (the UI-agnostic core) over a
    loaded ``model`` and ``tokenizer``; :meth:`load` reads them from a
    checkpoint directory."""

    def __init__(self, model, tokenizer, *, kv_reuse: bool = False, engine: bool = False):
        self.model = model
        self.config = model.config
        self.tokenizer = tokenizer
        self.kv_reuse = kv_reuse
        self.engine_mode = engine
        self.session = None
        self.engine = None
        self.reset()

    @classmethod
    def load(cls, model_path: str, processor_path: Optional[str] = None, dtype_name: str = "bf16",
             device: str = "cuda", int8_lm: bool = False, int8_kv: bool = False, int8_vision: bool = False,
             **kw) -> "EilevChat":
        from ..models.auto import load_model, load_tokenizer

        model, _ = load_model(model_path, dtype=DTYPES[dtype_name], int8_lm=int8_lm, int8_kv=int8_kv,
                              int8_vision=int8_vision, device=device)
        return cls(model, load_tokenizer(processor_path or model_path), **kw)

    def reset(self) -> None:
        # blocks of (text, number of videos before the text), the original's state
        self.prompts: list[tuple[str, int]] = [("", 0)]
        self.videos: list[np.ndarray] = []
        if self.session is not None:
            self.session.reset()

    def add_video(self, path: str) -> str:
        from ..native import VideoDecoder

        if self.prompts[-1][0] != "":
            self.prompts.append(("", 0))
        with VideoDecoder(path) as dec:
            end = min(MAX_CLIP_SECONDS, dec.duration)
            self.videos.append(dec.decode_clip(0.0, end, NUM_FRAMES))
        text, n = self.prompts[-1]
        self.prompts[-1] = (text, n + 1)
        return f"[added video {len(self.videos)}: {path}]"

    def add_text(self, text: str) -> None:
        block, n = self.prompts[-1]
        self.prompts[-1] = ((block + " " + text).strip(), n)

    # -- turn plumbing ------------------------------------------------------

    def _greedy_config(self, **knobs):
        from ..configs import OPTConfig
        from ..generation import GenerationConfig

        gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=self.tokenizer.pad_token_id, **knobs)
        if isinstance(self.config.text_config, OPTConfig):
            gen_cfg = gen_cfg.with_eos(OPT_NEWLINE)
        return gen_cfg

    def _turn_inputs(self, user_text: str) -> dict:
        """Add the user's text, build the whole interleaved prompt; the
        videos preprocessed on the model's device (None without videos)."""
        from ..data.prompts import generate_input_ids_and_labels_from_interleaved
        from ..ops.preprocess import process_videos

        if user_text.strip():
            self.add_text(user_text.strip())
        inputs = generate_input_ids_and_labels_from_interleaved(
            self.tokenizer, self.prompts, None, self.config.num_query_tokens,
            self.config.use_decoder_only_language_model,
        )
        pixel = None
        if self.videos:
            img = self.config.vision_config.image_size
            device = next(self.model.parameters()).device
            pixel = process_videos(torch.from_numpy(np.stack(self.videos)).to(device), height=img, width=img,
                                   dtype=self.model.compute_dtype)
        return {"input_ids": np.asarray(inputs["input_ids"]), "pixel": pixel,
                "video_input_mask": np.asarray(inputs["video_input_mask"])}

    def _reply(self, tokens) -> str:
        reply = self.tokenizer.decode([int(t) for t in tokens], skip_special_tokens=True).strip()
        self.add_text(reply)
        return reply

    def _generate_kwargs(self, inputs: dict) -> dict:
        device = next(self.model.parameters()).device
        kw = {"input_ids": torch.from_numpy(inputs["input_ids"])[None].to(device)}
        if inputs["pixel"] is not None:
            kw.update(pixel_values=inputs["pixel"],
                      video_input_mask=torch.from_numpy(inputs["video_input_mask"])[None].to(device))
        return kw

    # -- the modes ------------------------------------------------------------

    def respond_kv_reuse(self, user_text: str) -> str:
        """A greedy turn over a persistent ``ChatSession``: only this turn's
        new tokens and videos are prefilled; token-identical to a greedy turn
        from scratch."""
        from ..serving import ChatSession

        if self.session is None:
            self.session = ChatSession(self.model, self._greedy_config())
        inputs = self._turn_inputs(user_text)
        return self._reply(self.session.turn(inputs["input_ids"], inputs["pixel"], inputs["video_input_mask"]))

    def respond_engine(self, user_text: str) -> str:
        """A greedy turn through a persistent ``ContinuousBatchingEngine``
        (2 slots, video_bucket 4: every turn's video count shares one encode
        shape); the same engine could serve other chats' requests at once."""
        from ..serving import ContinuousBatchingEngine, Request

        if self.engine is None:
            self.engine = ContinuousBatchingEngine(self.model, self._greedy_config(), max_slots=2, max_len=2048,
                                                   chunk_tokens=8, prefill_bucket=256, video_bucket=4)
        inputs = self._turn_inputs(user_text)
        req = Request(input_ids=inputs["input_ids"], pixel_values=inputs["pixel"],
                      video_input_mask=inputs["video_input_mask"] if inputs["pixel"] is not None else None)
        (completion,) = self.engine.run([req]).values()
        pad = self.engine.gen_cfg.pad_token_id
        return self._reply(t for t in completion.tokens if t != pad)

    def respond(self, user_text: str) -> str:
        """The original demo's turn: beam-5, length_penalty -1, from scratch
        (or the mode chosen at construction)."""
        from ..generation import generate

        if self.kv_reuse:
            return self.respond_kv_reuse(user_text)
        if self.engine_mode:
            return self.respond_engine(user_text)
        inputs = self._turn_inputs(user_text)
        tokens = generate(self.model, generation_config=self._greedy_config(num_beams=5, length_penalty=-1.0),
                          **self._generate_kwargs(inputs))
        reply = self.tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)[0].strip()
        self.add_text(reply)
        return reply

    def respond_stream_kv_reuse(self, user_text: str):
        """A streaming turn over the persistent session: incremental prefill
        and chunked token streaming; yields text deltas."""
        from ..serving import ChatSession

        if self.session is None:
            self.session = ChatSession(self.model, self._greedy_config())
        inputs = self._turn_inputs(user_text)
        chunks = self.session.turn_stream(inputs["input_ids"], inputs["pixel"], inputs["video_input_mask"])
        yield from self._stream_text(chunks)

    def respond_stream(self, user_text: str):
        """The greedy streaming turn from scratch (beam search cannot stream):
        yields text deltas as token chunks arrive."""
        from ..generation import generate_stream

        if self.kv_reuse:
            yield from self.respond_stream_kv_reuse(user_text)
            return
        gen_cfg = self._greedy_config()
        inputs = self._turn_inputs(user_text)
        chunks = (
            [t for t in chunk[0].tolist() if t != gen_cfg.pad_token_id]
            for chunk in generate_stream(self.model, generation_config=gen_cfg, **self._generate_kwargs(inputs))
        )
        yield from self._stream_text(chunks)

    def _stream_text(self, chunks):
        emitted: list[int] = []
        shown = ""
        for chunk in chunks:
            emitted.extend(int(t) for t in chunk)
            text = self.tokenizer.decode(emitted, skip_special_tokens=True)
            if len(text) > len(shown):
                yield text[len(shown):]
                shown = text
        self.add_text(shown.strip())


def run_terminal(chat: EilevChat, stream: bool = False) -> None:
    print("EILeV chat (terminal mode). Commands: /video <path>, /reset, /quit")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "/quit":
            break
        if line == "/reset":
            chat.reset()
            print("[reset]")
            continue
        if line.startswith("/video "):
            print(chat.add_video(line[len("/video "):].strip()))
            continue
        if stream:
            for delta in chat.respond_stream(line):
                print(delta, end="", flush=True)
            print()
        else:
            print(chat.respond(line))


def run_gradio(chat: EilevChat, share: bool) -> None:
    import gradio as gr  # type: ignore

    with gr.Blocks(title="EILeV Demo") as app:
        chatbot = gr.Chatbot()
        with gr.Row():
            video_in = gr.Video(label="Add a video")
            text_in = gr.Textbox(label="Message")
        clear = gr.Button("Reset")

        def on_video(video, history):
            if video:
                history = (history or []) + [(chat.add_video(video), None)]
            return history

        def on_text(text, history):
            return "", (history or []) + [(text, chat.respond(text))]

        def on_clear():
            chat.reset()
            return []

        video_in.change(on_video, [video_in, chatbot], chatbot)
        text_in.submit(on_text, [text_in, chatbot], [text_in, chatbot])
        clear.click(on_clear, None, chatbot)
    app.launch(share=share)


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--processor", default=None)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--int8_lm", action="store_true", help="weight-only int8 LM serving mode")
    p.add_argument("--int8_kv", action="store_true", help="int8 KV cache, read by kernel K4")
    p.add_argument("--int8_vision", action="store_true", help="W8A8 vision tower (serving mode)")
    p.add_argument("--kv_reuse", action="store_true",
                   help="keep the session KV cache across turns and prefill only each turn's new tokens and "
                        "videos (greedy; the default beam-5 re-prefills like the original demo)")
    p.add_argument("--engine", action="store_true",
                   help="serve turns through a persistent continuous-batching engine (greedy; every turn's "
                        "videos encoded in fixed buckets of 4)")
    p.add_argument("--terminal", action="store_true", help="force terminal mode")
    p.add_argument("--stream", action="store_true",
                   help="terminal mode: stream tokens as they decode (greedy; beam search cannot stream)")
    p.add_argument("--share", action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)
    chat = EilevChat.load(args.model, args.processor, args.dtype, device=args.device, int8_lm=args.int8_lm,
                          int8_kv=args.int8_kv, int8_vision=args.int8_vision, kv_reuse=args.kv_reuse,
                          engine=args.engine)
    if args.terminal or args.stream:
        run_terminal(chat, stream=args.stream)
        return
    try:
        run_gradio(chat, args.share)
    except ImportError:
        print("gradio not installed; falling back to terminal mode")
        run_terminal(chat)


if __name__ == "__main__":
    main()
