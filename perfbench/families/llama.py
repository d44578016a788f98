"""The Llama family (`model_type` "llama"): the widths of a published block,
its leaves and the work one forward does.

A layer is RMSNorm, grouped-query attention with rotary positions over
`wq`, `wk`, `wv`, `wo`, RMSNorm and a SwiGLU MLP over `w_gate`, `w_up`,
`w_down`; then a final norm and the head. `reference/llama.py` is its plain
forward and `program/llama.py` hands it to the port.

Nothing here imports the program.
"""

import math
from dataclasses import dataclass

# The projections of one layer, in the order the port's `LayerParams` has them.
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class Dims:
    """The widths of one model, read from its published config."""

    vocab: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    tied: bool

    def shape(self, leaf: str) -> tuple:
        """`[in, out]` of a projection (the `x @ W` layout)."""
        E, F, D = self.hidden, self.intermediate, self.head_dim
        return {"wq": (E, self.heads * D), "wk": (E, self.kv_heads * D),
                "wv": (E, self.kv_heads * D), "wo": (self.heads * D, E),
                "w_gate": (E, F), "w_up": (E, F), "w_down": (F, E)}[leaf]

    def projection_params(self) -> int:
        """Weights of the matrix products of one token: every layer's
        projections and the head."""
        per_layer = sum(math.prod(self.shape(n)) for n in PROJECTIONS)
        return self.layers * per_layer + self.hidden * self.vocab

    # ---- the work of one forward call (`perfbench/work.py::Call`) ----

    def row_flops(self) -> int:
        """Flops of one query row through every weight matrix."""
        return 2 * self.projection_params()

    def attention(self, call) -> list:
        """`(flops, bytes, launches)` of the call's attention: one launch a
        layer, 4 H D flops a query-key pair (scores and values), the bf16
        queries, output and each distinct K and V row read once."""
        H, Hkv, D = self.heads, self.kv_heads, self.head_dim
        flops = 4.0 * H * D * call.keys
        nbytes = 2.0 * (2 * call.rows * H * D + 2 * call.kv_rows * Hkv * D)
        return [(flops, nbytes, self.layers)]

    def matmuls(self) -> list:
        """`(launches, [(K, N, output bytes), ...])`: the weight matrices a
        forward streams, each group launched that many times: every layer's
        seven projections (bf16 out), then the head (f32 logits)."""
        return [(self.layers, [(*self.shape(n), 2) for n in PROJECTIONS]),
                (1, [(self.hidden, self.vocab, 4)])]


def dims(hf: dict) -> Dims:
    """The widths of a published Llama block (HF `config.json` keys)."""
    heads = hf["num_attention_heads"]
    return Dims(vocab=hf["vocab_size"], hidden=hf["hidden_size"],
                intermediate=hf["intermediate_size"], layers=hf["num_hidden_layers"],
                heads=heads, kv_heads=hf.get("num_key_value_heads", heads),
                head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
                rope_theta=float(hf.get("rope_theta", 10000.0)),
                eps=float(hf.get("rms_norm_eps", 1e-5)),
                tied=bool(hf.get("tie_word_embeddings", False)))
