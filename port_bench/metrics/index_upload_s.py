"""Host seconds of Mapper.from_oracle_index in set-up (mid_occ, the
device index's planner and upload, ops/index_ops.py), ending in
torch.cuda.synchronize()."""


def read(rec):
    return rec["setup"].get("index_upload_s")
