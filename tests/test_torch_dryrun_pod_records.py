"""The port's pod dry-run records against those it reckoned before each
placement went in, on the CPU (moved out of ``test_torch_dryrun.py``, the
tier-1 run's longest file, unchanged):

  * minitron_4b's train_4k records on both pod meshes, to the byte, as
    reckoned before FSDP (its pod meshes put zero = 1);
  * the MoE and VLM configs' single-pod peaks below those of the gathered
    compute, the dense configs' records to the byte;
  * the recurrent and encoder-decoder families' single-pod peaks below
    those of the gathered compute, the MoE and VLM records to the byte;
  * deepseek_67b's train_4k under FSDP within one card per rank.
"""

import json

import pytest

from repro_torch.launch import dryrun as DR


# minitron_4b train_4k rank-0 records as `python -m repro_torch.launch.dryrun
# --arch minitron_4b --shape train_4k --mesh both` reckoned them at commit
# 15cbd72, before FSDP: its pod meshes put zero = 1, so FSDP must move none
# of these numbers
MINITRON_TRAIN_4K_AT_15CBD72 = {
    "single": {
        "memory": {
            "eval_bytes": 0,
            "global_bytes": 1077470000,
            "init_bytes": 5488321536,
            "local_bytes": 52154748936,
            "peak_bytes": 56033169288,
            "state_bytes": 3878420352,
        },
        "comm": {
            "all_gather@model": {"bytes": 2416513536, "calls": 4620},
            "all_gather_shards": {"bytes": 33670912, "calls": 1},
            "all_reduce_max@model": {"bytes": 3145728, "calls": 24},
            "all_reduce_sum": {"bytes": 28, "calls": 1},
            "all_reduce_sum@model": {"bytes": 637808934940, "calls": 841},
            "gather_workers": {"bytes": 48, "calls": 1},
            "scatter_rows": {"bytes": 538734592, "calls": 1},
        },
        "flops": 9444736163119104,
        "collectives": {
            "all-gather": 2450184496,
            "all-reduce": 637812080696,
            "all-to-all": 0,
            "collective-permute": 0,
            "reduce-scatter": 538734592,
            "wire_bytes": 1278613080480,
        },
        "t_collective_s": 25.5722616096,
        "t_compute_s": 9.54978378475137,
        "fits_per_card": True,
        "kernel_bytes_per_round": 71348170920,
    },
    "multi": {
        "memory": {
            "eval_bytes": 0,
            "global_bytes": 1077478960,
            "init_bytes": 5437815552,
            "local_bytes": 26149638152,
            "peak_bytes": 29974406792,
            "state_bytes": 3824768640,
        },
        "comm": {
            "all_gather@model": {"bytes": 2416513536, "calls": 4620},
            "all_gather_shards": {"bytes": 16835584, "calls": 1},
            "all_reduce_max@model": {"bytes": 1572864, "calls": 24},
            "all_reduce_sum": {"bytes": 28, "calls": 1},
            "all_reduce_sum@model": {"bytes": 318904467484, "calls": 841},
            "gather_workers": {"bytes": 48, "calls": 1},
            "scatter_rows": {"bytes": 538738688, "calls": 1},
        },
        "flops": 4722368081559552,
        "collectives": {
            "all-gather": 2433349168,
            "all-reduce": 318906040376,
            "all-to-all": 0,
            "collective-permute": 0,
            "reduce-scatter": 538738688,
            "wire_bytes": 640784168608,
        },
        "t_collective_s": 12.81568337216,
        "t_compute_s": 4.774891892375685,
        "fits_per_card": True,
        "kernel_bytes_per_round": 71230323540,
    },
}


@pytest.mark.parametrize("multi", [False, True])
def test_fsdp_leaves_minitron_4b_train_records_as_they_were(multi):
    """minitron_4b's pod meshes put zero = 1: its train_4k record's numbers
    equal, to the byte, those reckoned at 15cbd72, before FSDP."""
    rec = DR.reckon_pod("minitron_4b", "train_4k", multi)
    assert rec["mesh"]["zero"] == 1 and not rec["batch_over_zero"]
    before = MINITRON_TRAIN_4K_AT_15CBD72["multi" if multi else "single"]
    for key, value in before.items():
        assert rec[key] == value, key


# rank 0's peak per card of the single pod's records, in GB, as
# `python -m repro_torch.launch.dryrun --arch llama4_maverick_400b_a17b,
# llava_next_34b --shape train_4k,prefill_32k,decode_32k --mesh single`
# reckoned them at commit c1b9463, before the model axis split the MoE FFN
# and the VLM: every rank gathered every leaf whole and computed replicated
GATHERED_PEAK_GB_AT_C1B9463 = {
    ("llama4_maverick_400b_a17b", "train_4k"): 1624.52,
    ("llama4_maverick_400b_a17b", "prefill_32k"): 857.06,
    ("llava_next_34b", "train_4k"): 188.02,
    ("llava_next_34b", "prefill_32k"): 148.29,
    ("llava_next_34b", "decode_32k"): 135.51,
}


@pytest.mark.parametrize("arch,shape", list(GATHERED_PEAK_GB_AT_C1B9463),
                         ids=[f"{a}-{s}" for a, s in GATHERED_PEAK_GB_AT_C1B9463])
def test_split_moe_and_vlm_records_reckon_less_per_rank(arch, shape):
    """The MoE FFN and the VLM split over the model axis: each of these
    single-pod records reckons a lower peak per rank than the gathered
    compute did, and its collectives are the placements' reckoning."""
    rec = DR.reckon_pod(arch, shape, False)
    assert rec["memory"]["peak_bytes"] < GATHERED_PEAK_GB_AT_C1B9463[(arch, shape)] * 1e9
    assert rec["collectives"]["all-reduce"] > 0


# sha256 (first 16 hex digits) of json.dumps({"memory", "comm", "flops"},
# sort_keys=True) of the dense configs' single-pod records, as
# DR.reckon_pod gave them at commit c1b9463
DENSE_RECORDS_AT_C1B9463 = {
    "nano.train_4k": "e25916e42ad00cf6",
    "nano.prefill_32k": "929a7f4471235fdd",
    "nano.decode_32k": "0fa99d7713931e0d",
    "gpt2_small_smoke.train_4k": "7fb877630cc6389a",
    "gpt2_small_smoke.prefill_32k": "1e873d4c7dd8ddc3",
    "gpt2_small_smoke.decode_32k": "06386c04248aed2b",
    "minitron_4b_smoke.train_4k": "24e7c9074240b760",
    "minitron_4b_smoke.prefill_32k": "8cca553f81a0248e",
    "minitron_4b_smoke.decode_32k": "f4520686f89a89d4",
    "granite_34b_smoke.train_4k": "ba8b7cdc6155d9d8",
    "granite_34b_smoke.prefill_32k": "4478b8112400bfd8",
    "granite_34b_smoke.decode_32k": "dc6dc0adcbf33dc0",
    "deepseek_67b_smoke.train_4k": "e1b72e1ae861f27a",
    "deepseek_67b_smoke.prefill_32k": "8cca553f81a0248e",
    "deepseek_67b_smoke.decode_32k": "f4520686f89a89d4",
    "gemma3_1b_smoke.train_4k": "1fa40a5604e26997",
    "gemma3_1b_smoke.prefill_32k": "6d20118d4981df0b",
    "gemma3_1b_smoke.decode_32k": "d0a3f02319ba50a1",
}


def test_split_moe_and_vlm_leave_dense_records_as_they_were():
    """The dense configs' single-pod records (training and serving) are
    those reckoned at c1b9463, to the byte (so is minitron_4b's at full
    width: :func:`test_fsdp_leaves_minitron_4b_train_records_as_they_were`)."""
    import hashlib

    for key, digest in DENSE_RECORDS_AT_C1B9463.items():
        arch, shape = key.split(".")
        rec = DR.reckon_pod(arch, shape, False)
        keep = {k: rec[k] for k in ("memory", "comm", "flops")}
        assert hashlib.sha256(json.dumps(keep, sort_keys=True).encode()).hexdigest()[:16] == \
            digest, key


# rank 0's peak per card of the single pod's records, in GB, as `python -m
# repro_torch.launch.dryrun --arch mamba2_780m,recurrentgemma_2b,
# whisper_large_v3 --shape all --mesh single` reckoned them at commit
# 13ebcdb, before the model axis split the recurrent and encoder-decoder
# families: every rank gathered every leaf whole and computed replicated
FAMILY_PEAK_GB_AT_13EBCDB = {
    ("recurrentgemma_2b", "train_4k"): 257.92,
    ("recurrentgemma_2b", "prefill_32k"): 24.47,
    ("recurrentgemma_2b", "decode_32k"): 8.56,
    ("recurrentgemma_2b", "long_500k"): 8.43,
    ("whisper_large_v3", "train_4k"): 60.80,
    ("whisper_large_v3", "prefill_32k"): 36.15,
    ("whisper_large_v3", "decode_32k"): 50.69,
    ("mamba2_780m", "train_4k"): 53.63,
    ("mamba2_780m", "prefill_32k"): 11.62,
    ("mamba2_780m", "decode_32k"): 2.49,
    ("mamba2_780m", "long_500k"): 1.95,
}
# sha256 (first 16 hex digits) of json.dumps({"memory", "comm", "flops"},
# sort_keys=True) of the MoE and VLM configs' single-pod records, as
# DR.reckon_pod gave them at commit 13ebcdb (the dense configs':
# DENSE_RECORDS_AT_C1B9463)
MOE_VLM_RECORDS_AT_13EBCDB = {
    "granite_moe_3b_a800m_smoke.train_4k": "0a0a865c21456f60",
    "granite_moe_3b_a800m_smoke.prefill_32k": "32d176d3f5c01e77",
    "granite_moe_3b_a800m_smoke.decode_32k": "38027193c8aa9ea0",
    "llama4_maverick_400b_a17b_smoke.train_4k": "bd90e5634326c5a2",
    "llama4_maverick_400b_a17b_smoke.prefill_32k": "bc455a057ea07c14",
    "llama4_maverick_400b_a17b_smoke.decode_32k": "fba569a359e54b4a",
    "llava_next_34b_smoke.train_4k": "510f6e6f6fbeb6e4",
    "llava_next_34b_smoke.prefill_32k": "f805f8073bc33262",
    "llava_next_34b_smoke.decode_32k": "9b7305ac4ddc6f50",
}


def test_split_families_records_reckon_less_per_rank():
    """The recurrent and encoder-decoder families split over the model
    axis: the single-pod records of their train_4k and prefill_32k reckon
    a lower peak per rank than the gathered compute did, recurrentgemma_2b
    train_4k now fits one card per rank, and no decode_32k or long_500k
    record grows; the MoE and VLM configs' records are those reckoned at
    13ebcdb, to the byte (the dense configs':
    :func:`test_split_moe_and_vlm_leave_dense_records_as_they_were`)."""
    import hashlib

    for (arch, shape), before in FAMILY_PEAK_GB_AT_13EBCDB.items():
        rec = DR.reckon_pod(arch, shape, False)
        peak = rec["memory"]["peak_bytes"]
        if shape in ("train_4k", "prefill_32k"):
            assert peak < before * 1e9, (arch, shape, peak)
            assert rec["collectives"]["all-reduce"] > 0
        else:
            assert peak <= (before + 0.005) * 1e9, (arch, shape, peak)
        if (arch, shape) == ("recurrentgemma_2b", "train_4k"):
            assert rec["fits_per_card"]
    for key, digest in MOE_VLM_RECORDS_AT_13EBCDB.items():
        arch, shape = key.split(".")
        rec = DR.reckon_pod(arch, shape, False)
        keep = {k: rec[k] for k in ("memory", "comm", "flops")}
        assert hashlib.sha256(json.dumps(keep, sort_keys=True).encode()).hexdigest()[:16] == \
            digest, key


def test_fsdp_deepseek_67b_train_4k_fits_one_card_per_rank():
    """deepseek_67b at train_4k on the single pod, (worker 2, zero 8, model
    16): B_micro 8 splits over zero, and the rank's reckoned peak falls
    from over 120 GB (blocks whole over zero) to under one card."""
    rec = DR.reckon_pod("deepseek_67b", "train_4k", False)
    assert rec["mesh"] == {"worker": 2, "zero": 8, "model": 16} and rec["batch_over_zero"]
    assert rec["fits_per_card"] and rec["memory"]["peak_bytes"] < 0.25 * 122.43e9
    assert rec["comm"]["all_gather@zero"]["calls"] > 0
