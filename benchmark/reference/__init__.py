"""The benchmark's plain reference: one WaterLily step and its body
measurement in eager PyTorch, independent of the measured program."""
