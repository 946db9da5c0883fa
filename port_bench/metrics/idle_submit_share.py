"""The share, in %, of the window in which the card waited on the
mapper's calling thread's grouping and on its submit thread, on the
device clock: each call's start to its first batch (dev_idle_head: the
length sort and grouping on the calling thread, then the first encode on
the submit thread) and the gaps before each later batch of the first
phase (dev_idle_feed), from Mapper.stats, over the window's host
seconds. The card's waits for launches inside a batch are not in it:
the stage metrics count them."""


def read(rec):
    st = rec["stats"]
    if "dev_idle_head" not in st or "dev_idle_feed" not in st or rec["window_s"] <= 0:
        return None
    return 100.0 * (st["dev_idle_head"] + st["dev_idle_feed"]) / rec["window_s"]
