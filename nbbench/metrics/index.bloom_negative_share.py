"""index.bloom_negative_share: Bloom probes that answered "absent" over all
probes in the window, in percent.  The descent still searches every row, so
this is the share of searches whose result is thrown away."""


def read(obs):
    if not obs.counters or not obs.counters["bloom_probes"]:
        return None
    return (100.0 * obs.counters["bloom_negative_skips"]
            / obs.counters["bloom_probes"])
