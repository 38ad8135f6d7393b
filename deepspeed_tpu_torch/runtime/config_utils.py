"""Helpers for reading params out of a raw config dict (port of
``deepspeed_tpu/runtime/config_utils.py``, the part the config uses)."""


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while parsing JSON."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
