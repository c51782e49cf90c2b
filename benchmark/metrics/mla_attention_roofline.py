"""mla_attention_roofline: the bound of every latent-attention launch the
traced block served (the latent rows up to its keys, q and out once; every
query row of every head against every key, 576-deep scores and 512-wide
values; the family's work, `run.dims.mla_bound_s`) over the device time of
the MLA kernel (`mla_attention`), in percent. A family without latent
attention, or a program without the kernel, reads nothing."""


def read(run):
    t = run.trace.family_s.get("mla_attention")
    bound_s = getattr(run.dims, "mla_bound_s", None)
    if not t or bound_s is None:
        return None
    return 100.0 * bound_s(run.traced) / t
