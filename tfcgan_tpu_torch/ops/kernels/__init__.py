"""Wrappers of the hand-written Hopper kernels in ``tfcgan_tpu_torch/csrc``."""


def launch_counts() -> dict[str, int]:
    """Every wrapper's launch count in this process, by kernel."""
    from tfcgan_tpu_torch.ops.kernels import blurpool, flashattn, gridsample, resample

    return {"blurpool_fwd": blurpool.LAUNCHES, "blurpool_bwd": blurpool.BWD_LAUNCHES,
            "resample_fwd": resample.FWD_LAUNCHES, "resample_adjoint": resample.ADJOINT_LAUNCHES,
            "resample_gradpos": resample.GRADPOS_LAUNCHES,
            "gridsample_fwd": gridsample.FWD_LAUNCHES, "gridsample_bwd": gridsample.BWD_LAUNCHES,
            "flashattn_fwd": flashattn.FWD_LAUNCHES, "flashattn_bwd_dq": flashattn.DQ_LAUNCHES,
            "flashattn_bwd_dkv": flashattn.DKV_LAUNCHES,
            "flashattn_fwd_tc": flashattn.FWD_TC_LAUNCHES,
            "flashattn_bwd_dq_tc": flashattn.DQ_TC_LAUNCHES,
            "flashattn_bwd_dkv_tc": flashattn.DKV_TC_LAUNCHES}
