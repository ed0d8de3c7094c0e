"""Seq2seq: RNN encoder/decoder with a state bridge and greedy infer (port
of ``models/seq2seq/seq2seq.py``).

Reference: zoo/models/seq2seq/Seq2seq.scala:50, RNNEncoder/RNNDecoder,
Bridge.scala:156 ("pass" forwards encoder states; "dense" maps them
through a learned projection), and the token-by-token ``infer`` loop.

``prefill`` (encode + bridge) and ``decode_step`` (one greedy token) are
the two functions the generative story is built from: ``infer`` loops
``decode_step`` in Python on the device the weights live on (the
reference runs the loop as one compiled program), and the serving
engine's decode-slot scheduler (``serving/engine/decode.py``) calls
``decode_step`` once per scheduler iteration over the active slots.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import (
    Params, State, fold_name,
)
from analytics_zoo_torch.pipeline.api.keras.layers import Dense, Embedding
from analytics_zoo_torch.pipeline.api.keras.layers.recurrent import LSTM
from analytics_zoo_torch.pipeline.api.keras.topology import (
    KerasNet, tree_leaves,
)


class Seq2seq(KerasNet):
    """Token seq2seq over a shared vocab (chatbot example workload)."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden_sizes: Sequence[int] = (128,),
                 bridge: str = "pass", name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.hidden_sizes = list(hidden_sizes)
        if bridge not in ("pass", "dense"):
            raise ValueError(f"unknown bridge {bridge!r}; use pass|dense")
        if bridge == "pass" and len(set(self.hidden_sizes)) != 1:
            raise ValueError(
                "bridge='pass' feeds the encoder carry to the decoder "
                f"unchanged: hidden_sizes {self.hidden_sizes} must agree")
        self.bridge = bridge

        self.embedding = Embedding(self.vocab_size, self.embed_dim,
                                   init="uniform")
        self.encoder_rnns = [LSTM(h, return_sequences=True)
                             for h in self.hidden_sizes]
        self.decoder_rnns = [LSTM(h, return_sequences=True)
                             for h in self.hidden_sizes]
        self.bridge_layers = (
            [Dense(2 * h) for h in self.hidden_sizes]
            if bridge == "dense" else [])
        self.generator = Dense(self.vocab_size)
        self.layers = ([self.embedding] + self.encoder_rnns +
                       self.decoder_rnns + self.bridge_layers +
                       [self.generator])
        self.batch_input_shape = [(None, None), (None, None)]

    # ------------------------------------------------------------ building
    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        params[self.embedding.name] = self.embedding.init(
            fold_name(rng, self.embedding.name), (None, 1))["params"]
        shape = (None, None, self.embed_dim)
        for enc, dec in zip(self.encoder_rnns, self.decoder_rnns):
            params[enc.name] = enc.init(
                fold_name(rng, enc.name), shape)["params"]
            params[dec.name] = dec.init(
                fold_name(rng, dec.name), shape)["params"]
            shape = (None, None, enc.output_dim)
        for i, bl in enumerate(self.bridge_layers):
            h = self.hidden_sizes[i]
            params[bl.name] = bl.init(
                fold_name(rng, bl.name), (None, 2 * h))["params"]
        params[self.generator.name] = self.generator.init(
            fold_name(rng, self.generator.name),
            (None, self.hidden_sizes[-1]))["params"]
        return params

    def init_state(self, input_shape) -> State:
        return {}

    def compute_output_shape(self, input_shape):
        dec_shape = input_shape[1]
        return (dec_shape[0], dec_shape[1], self.vocab_size)

    # ------------------------------------------------------------- forward
    def _encode(self, params, enc_ids):
        x = self.embedding.call(params[self.embedding.name], enc_ids)
        carries = []
        for enc in self.encoder_rnns:
            x, carry = enc.run(params[enc.name], x)
            carries.append(carry)
        return carries

    def _bridge(self, params, carries):
        if self.bridge == "pass":
            return carries
        out = []
        for bl, (h, c) in zip(self.bridge_layers, carries):
            joined = torch.cat([h, c], dim=-1)
            mapped = bl.call(params[bl.name], joined)
            nh, nc = mapped.chunk(2, dim=-1)
            out.append((nh, nc))
        return out

    def apply(self, params, inputs, state=None, training=False, rng=None):
        """Teacher-forced logits (batch, dec_len, vocab)."""
        enc_ids, dec_ids = inputs
        carries = self._bridge(params, self._encode(params, enc_ids))
        x = self.embedding.call(params[self.embedding.name], dec_ids)
        for dec, carry in zip(self.decoder_rnns, carries):
            x, _ = dec.run(params[dec.name], x, initial_carry=carry)
        logits = self.generator.call(params[self.generator.name], x)
        return logits, state

    # ------------------------------------------------- decode primitives
    def prefill(self, params: Params, enc_ids):
        """Encode + bridge: the per-sequence decode state a new sequence
        enters the decode loop with.  ``enc_ids`` (batch, enc_len) int
        tensor → tuple of per-layer LSTM carries, each an ``(h, c)`` pair
        of (batch, hidden) float32 tensors."""
        return tuple(self._bridge(params, self._encode(params, enc_ids)))

    def decode_step(self, params: Params, tok, carries):
        """One greedy decode iteration: last token (batch,) int32 +
        carries → (next token (batch,) int32, new carries)."""
        x = self.embedding.call(params[self.embedding.name], tok[:, None])
        new_carries = []
        for dec, carry in zip(self.decoder_rnns, carries):
            x, nc = dec.run(params[dec.name], x, initial_carry=carry)
            new_carries.append(nc)
        logits = self.generator.call(params[self.generator.name], x[:, 0])
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, tuple(new_carries)

    def _device(self) -> torch.device:
        return tree_leaves(self.get_variables()["params"])[0].device

    def initial_carries(self, batch: int):
        """Zero decode state shaped like one ``prefill`` row batch, on the
        weights' device — the slot pool's resting state for unoccupied
        slots.  Each layer's (h, c) is one zeros tensor twice."""
        device = self._device()
        return tuple(dec.initial_carry(batch, device)
                     for dec in self.decoder_rnns)

    def decode_params(self) -> Params:
        return self.get_variables()["params"]

    # --------------------------------------------------------------- infer
    def infer(self, enc_ids: np.ndarray, start_sign: int,
              max_seq_len: int = 30, stop_sign: Optional[int] = None,
              early_exit: bool = True, return_steps: bool = False):
        """Greedy decode on the weights' device, through
        ``compile.engine_jit`` as the reference's is.

        With a ``stop_sign`` and ``early_exit`` the loop ends the moment
        every sequence has emitted the stop token (one host read of
        ``stopped.all()`` an iteration): a batch that finishes at step 5
        pays 5 iterations, not ``max_seq_len``; a stopped lane records
        ``stop_sign`` while the raw token still feeds back, so the
        executed steps equal the whole-sequence loop's.  The prefill and
        each decode step are programs of their own (a CUDA graph each on
        the card), the step writing its column of the output at a device
        index it advances: the reference's ``while_loop`` keeps its test
        on the device, which a CUDA graph cannot without conditional
        nodes, so the host reads it between replays.  Otherwise all
        ``max_seq_len`` steps run as ONE program, then everything after
        the first stop token is masked on the host.  Both give the same
        array.  ``return_steps=True`` also returns how many decode
        iterations ran.  The programs are kept on the model, one set per
        (start, stop, length)."""
        params = self.get_variables()["params"]
        enc = torch.as_tensor(np.asarray(enc_ids, np.int32)).to(
            self._device())
        with torch.inference_mode():
            if stop_sign is not None and early_exit:
                prefill, step = self._infer_programs(
                    "early_exit", start_sign, max_seq_len, stop_sign)
                state = prefill(params, enc)
                steps = 0
                while steps < max_seq_len and not bool(state[3].all()):
                    state = step(params, *state)
                    steps += 1
                out = state[2].cpu().numpy()
            else:
                decode = self._infer_programs("scan", start_sign,
                                              max_seq_len, None)
                out = decode(params, enc).cpu().numpy()
                steps = max_seq_len
                if stop_sign is not None:
                    # mask everything after the first stop token
                    stopped = np.cumsum(out == stop_sign, axis=1) > 0
                    out = np.where(stopped, stop_sign, out).astype(np.int32)
        return (out, steps) if return_steps else out

    def _infer_programs(self, kind: str, start_sign: int, max_seq_len: int,
                        stop_sign: Optional[int]):
        """The engine-built programs of ``infer``: ``"scan"`` one program
        over the whole sequence; ``"early_exit"`` (prefill, step)."""
        from analytics_zoo_torch.compile import engine_jit
        cache = self.__dict__.setdefault("_infer_cache", {})
        key = (kind, int(start_sign), int(max_seq_len), stop_sign)
        if key in cache:
            return cache[key]

        def start(params, enc):
            carries = self.prefill(params, enc)
            tok = torch.full((enc.shape[0],), start_sign, dtype=torch.int32,
                             device=enc.device)
            return tok, carries

        if kind == "scan":
            def decode_scan(params, enc):
                tok, carries = start(params, enc)
                toks = []
                for _ in range(max_seq_len):
                    tok, carries = self.decode_step(params, tok, carries)
                    toks.append(tok)
                return torch.stack(toks, dim=1)
            progs = engine_jit(decode_scan, borrow_argnums=(0,),
                               key_hint="seq2seq_decode")
        else:
            def prefill(params, enc):
                tok, carries = start(params, enc)
                batch = enc.shape[0]
                out = torch.full((batch, max_seq_len), stop_sign,
                                 dtype=torch.int32, device=enc.device)
                stopped = torch.zeros((batch,), dtype=torch.bool,
                                      device=enc.device)
                i = torch.zeros((1,), dtype=torch.int64, device=enc.device)
                return tok, carries, out, stopped, i

            def step(params, tok, carries, out, stopped, i):
                tok, carries = self.decode_step(params, tok, carries)
                emit = torch.where(stopped, stop_sign, tok)
                out.index_copy_(1, i, emit[:, None])
                stopped |= emit == stop_sign
                i += 1
                return tok, carries, out, stopped, i
            # the weights are read (borrowed); out, stopped and i are
            # written in place (donated); the token and carries come back
            # fresh each step and are copied in
            progs = (engine_jit(prefill, borrow_argnums=(0,),
                                key_hint="seq2seq_prefill"),
                     engine_jit(step, borrow_argnums=(0,),
                                donate_argnums=(3, 4, 5),
                                key_hint="seq2seq_decode_early_exit"))
        cache[key] = progs
        return progs
