"""The benchmark's frozen input generators."""
