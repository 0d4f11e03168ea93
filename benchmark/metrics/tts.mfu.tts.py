"""Model FLOPs of the replies (each prompt's prefill, each code's GPT step
with the audio head, each chunk's HiFi-GAN pass), counted from shapes, over
the time with at least one reply in flight (host clock) at the bf16 peak,
over the replies answered in the window before the traced slice."""

from benchmark import stats, work


def read(run):
    cfg, g, v = run.config, run.config["gpt"], run.config["hifigan"]
    d, layers, vocab = g["gpt_n_model_channels"], g["gpt_layers"], g["gpt_num_audio_tokens"]
    flops, spans = 0.0, []
    for r in run.requests:
        codes = run.system.codes.get(r["id"])
        if not (r["ok"] and codes) or r["end"] > run.t_stamps:
            continue
        spans.append((r["sent"], r["end"]))
        prefix = g["cond_len"] + r["text_bucket"] + 1
        flops += sum(work.gpt_token_flops(d=d, layers=layers, vocab=vocab, pos=p, logits=False)
                     for p in range(prefix))
        n = 0
        for chunk in codes:
            c = chunk.shape[-1]
            flops += sum(work.gpt_token_flops(d=d, layers=layers, vocab=vocab, pos=prefix + n + j)
                         for j in range(c))
            flops += work.hifigan_flops(
                n_latents=c + cfg["left_context"], in_dim=v["input_dim"],
                channels=v["upsample_initial_channel"], rates=v["upsample_rates"],
                up_kernels=v["upsample_kernel_sizes"], res_kernels=v["resblock_kernel_sizes"],
                res_dilations=v["resblock_dilation_sizes"], code_stride=v["gpt_code_stride_len"],
                sample_rate=v["output_sample_rate"], input_sample_rate=v["input_sample_rate"],
                cond_dim=v["cond_dim"])
            n += c
    seconds = stats.union_length(spans)
    return 100.0 * flops / (seconds * work.BF16_FLOPS) if seconds > 0 else None
