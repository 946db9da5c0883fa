"""The prefix probe's share, in %, of its bound in the window: the query
keys the map programs' stage "probe" looked up (Mapper.stats
["probe_queries"], the minimizers of the reads it probed, padding left
out), each at one random 32-byte sector of the key table, the least any
lookup of a key reads, over the H100's 3.35 TB/s of HBM3 (the constants
written here so the yardstick does not move with the program), over the
stage's device seconds (Mapper.stats["dev_probe"])."""

BYTES_PER_QUERY = 32
PEAK_BYTES_PER_S = 3.35e12


def read(rec):
    st = rec["stats"]
    if not st.get("probe_queries") or not st.get("dev_probe"):
        return None
    return 100.0 * st["probe_queries"] * BYTES_PER_QUERY / PEAK_BYTES_PER_S / st["dev_probe"]
