"""The fused XTTS GPT step's share of its roofline, over the chunks wholly
inside the traced slice: Σ least time of each step (one per code, at cache
position pos + j, reading the pos + j written columns) over Σ device time
of the step's kernels."""

from benchmark import readers, work
from benchmark.trace import params

STEP = ("int8_product_kernel", "self_attention_kernel")


def read(run):
    if run.trace is None:
        return None
    g = run.config["gpt"]
    bound = spent = 0.0
    for rng in run.trace.ranges("bench.gpt_chunk"):
        p = params(rng.name)
        bound += sum(work.gpt_step_ms(L=g["gpt_layers"], D=g["gpt_n_model_channels"], bk=1,
                                      picked=p["pos"] + j, per_row_cols=p["pos"] + j + 1,
                                      sel_numel=p["t"])
                     for j in range(p["n"])) / 1e3
        spent += readers.dur_s(readers.named(run.trace.launched_in(rng), STEP))
    return 100.0 * bound / spent if spent > 0 else None
