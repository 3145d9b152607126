"""LLMTailor core of the port: manifests, policies, the layer registry."""
