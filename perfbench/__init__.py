"""The port's benchmark: cells of BENCHMARK.json run against repro_torch.

Everything here is the yardstick (traffic, reference, counts, peaks, trace
reading); the program under test is only ``repro_torch``.
"""
