"""The program's parameter names for a BERT / MiniLM encoder (``model_type: "bert"``)."""

from __future__ import annotations


def program_state(flat: dict) -> dict:
    """Benchmark weights (Flax paths, kernels [in, out]) -> the port's
    ``MiniLMEncoder`` parameter names (``Linear.weight`` [out, in])."""
    sd = {
        "word_embeddings.weight": flat["params/word_embeddings/embedding"],
        "position_embeddings.weight": flat["params/position_embeddings/embedding"],
        "token_type_embeddings.weight": flat["params/token_type_embeddings/embedding"],
        "embeddings_norm.weight": flat["params/embeddings_norm/scale"],
        "embeddings_norm.bias": flat["params/embeddings_norm/bias"],
    }
    linears = {"attention/query": "attention.query", "attention/key": "attention.key",
               "attention/value": "attention.value", "attention/output": "attention.output",
               "intermediate": "intermediate", "ffn_output": "ffn_output"}
    layer = 0
    while f"params/layer_{layer}/ffn_norm/scale" in flat:
        pre = f"params/layer_{layer}"
        for path, name in linears.items():
            sd[f"layers.{layer}.{name}.weight"] = flat[f"{pre}/{path}/kernel"].t()
            sd[f"layers.{layer}.{name}.bias"] = flat[f"{pre}/{path}/bias"]
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"layers.{layer}.{norm}.weight"] = flat[f"{pre}/{norm}/scale"]
            sd[f"layers.{layer}.{norm}.bias"] = flat[f"{pre}/{norm}/bias"]
        layer += 1
    return sd
