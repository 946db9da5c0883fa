"""The share, in %, of the window in which the card sat idle within a
call after the submit thread had fed it, on the device clock: the drain's
last post-processing, the wide pass, tier 2 and rescue phases' host work
and the join (Mapper.stats["dev_idle_tail"]), over the window's host
seconds."""


def read(rec):
    st = rec["stats"]
    if "dev_idle_tail" not in st or rec["window_s"] <= 0:
        return None
    return 100.0 * st["dev_idle_tail"] / rec["window_s"]
