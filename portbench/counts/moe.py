"""The routed expert layer's work (``moe.experts``: the experts' gate, up
and down products over the routed pairs, the shared experts' over the
tokens, the weighted combine): each expert's weights read once a layer
call at the compute dtype (all experts of the layer: at the cell's shapes
every expert gets tokens), the pairs' inputs read and outputs written
once; the router's work (``moe.route``) is not counted."""

from __future__ import annotations

from portbench.peaks import bound_s


def layer_call(tokens: int, spec: dict, item: int = 2):
    """(bytes, ops) of one expert layer over `tokens` tokens."""
    e, w = spec["embed_dim"], spec["moe_intermediate_size"]
    sw = spec["n_shared_experts"] * w
    pairs = tokens * spec["num_experts_per_tok"]
    ops = 2 * pairs * 3 * e * w + 2 * tokens * 3 * e * sw
    byts = ((min(spec["n_routed_experts"], pairs) * 3 * e * w + 3 * e * sw)
            * item + 2 * pairs * e * item)
    return byts, ops


def sample_call_bound_s(spec: dict, rows: int, decode_steps: int) -> float:
    """Least device time of a sampling call's expert layers: the prefill
    over the rows' K L prefix positions in every expert layer but the last
    (whose output feeds nothing), then every decode step's rows in every
    expert layer; each layer call bound by the larger of its bytes and its
    products."""
    layers = spec["num_layers"] - spec["first_k_dense_replace"]
    prefix = rows * spec["support_size"] * spec["max_len"]
    return ((layers - 1) * bound_s(*layer_call(prefix, spec))
            + decode_steps * layers * bound_s(*layer_call(rows, spec)))
