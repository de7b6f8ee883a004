"""The model zoo on PyTorch: the dense decoder family (llama, qwen,
granite, chameleon backbones) with grouped-query attention through the
flash attention kernel, the zamba2 hybrid (Mamba2 layers through the
mamba2_ssd kernel, one shared attention block), and the RWKV6 family
(time mix through the rwkv6_wkv kernel, channel mix)."""
