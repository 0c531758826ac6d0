"""Multi-device mapping, the counterpart of `shrimp_tpu/parallel/`:
genome shards in one process (`shard`, `mesh`), reads dealt to processes
(`multihost`), and the genome split across processes (`genome_axis`),
on `torch.distributed` where processes meet."""
