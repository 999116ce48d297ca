"""Model FLOPs utilisation of the synthesis window behind w2v-BERT 2.0: every
call's products (counts/w2v_bert.py: the Conformer layers to the semantic
layer, the projection and FSQ, the loop and its context) over the traced
window times the peak of the configuration's compute dtype, in %.  None
where the configuration's encoder is not w2v-BERT."""

from benchmark.counts import peaks
from benchmark.counts.w2v_bert import synth_call_flops


def read(trace):
    info = trace.info
    h = info.get("hubert") or {}
    if not trace.window_s or not trace.kernels or "left_max_position_embeddings" not in h:
        return None
    flops = sum(synth_call_flops(info, c) for c in info["calls"] if c.get("samples"))
    peak = peaks()["flops_per_s"][info["compute"]]
    return 100.0 * flops / (trace.window_s * peak)
