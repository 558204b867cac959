"""Batch rendering (PyTorch): ``interop`` packs instances and views,
``renderer`` turns them into RGB and depth observations."""
