"""Parallelism of the port: stage partitioning, the stage placement, the
recurrent pipeline and the node bootstrap (the pipeline half of
`mdi_llm_tpu/parallel/`)."""
