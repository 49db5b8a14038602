from repro_torch.data.synthetic import SyntheticCorpus, make_batch_iterator  # noqa: F401
