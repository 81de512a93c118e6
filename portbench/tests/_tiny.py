"""Small configurations and a small mix for the benchmark's CPU tests:
the cells' equations at a width a test run can hold."""
import copy

WEIGHTS = {"imbalance": 1.5, "diag_boost": 3.0, "bias_scale": 0.1,
           "pattern_seed": 7}
# tiny widths: fp32 gaps of 1e-6 against a TF32 control of 1e-3 or more
LIMITS = {"out_gap": 1e-4, "out_gap_median": 1e-4, "state_gap": 1e-4}

CONFIGS = {
    "lstmp": {"name": "tiny_lstmp", "driver": "rnn_frames", "dtype": "float32",
              "layers": [{"cell": "lstmp", "n_input": 12, "n_hidden": 32,
                          "proj": 16},
                         {"cell": "lstmp", "n_input": 16, "n_hidden": 32,
                          "proj": 16}],
              "block": [8, 8], "compression": 4.0, "weights": WEIGHTS,
              "limits": LIMITS},
    "gru": {"name": "tiny_gru", "driver": "rnn_frames", "dtype": "float32",
            "layers": [{"cell": "gru", "n_input": 12, "n_hidden": 32},
                       {"cell": "gru", "n_input": 32, "n_hidden": 32}],
            "block": [8, 8], "compression": 4.0, "weights": WEIGHTS,
            "limits": LIMITS},
}

MIX = {"loop": "closed", "slots": 12, "chunk_frames": 8, "frame_ms": 10,
       "utterance_frames": {"median": 9, "sigma": 0.4, "min": 6, "max": 14,
                            "pool": 64},
       "bank_frames": 256, "check_streams": 8}

OPEN_MIX = {**MIX, "loop": "open", "groups": 3, "frame_ms": 2}


def config(kind: str) -> dict:
    return copy.deepcopy(CONFIGS[kind])
