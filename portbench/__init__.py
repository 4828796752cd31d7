"""The benchmark of fewshot_torch (see README.md)."""
