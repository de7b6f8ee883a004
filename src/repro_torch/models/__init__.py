"""The model zoo on PyTorch: the dense decoder family (llama, qwen,
granite, chameleon backbones) with grouped-query attention through the
flash attention kernel."""
