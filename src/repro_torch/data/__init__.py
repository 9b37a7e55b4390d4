from repro_torch.data.pipeline import TaskTokenDistribution, batches
