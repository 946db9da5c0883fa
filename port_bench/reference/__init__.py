"""The plain reference the benchmark judges the mapper's PAF against:
minimap2_rs's mapping, written again in NumPy and torch. It imports
nothing of the mapper and takes nothing the mapper made; it works its
index out again from the genome's bases."""
