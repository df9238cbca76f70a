"""CLI applications: encoder, encoder-visualizer, decoder.

Same flag surface, defaults, and validation as the reference apps
(apps/encoder.cpp, apps/decoder.cpp), with framework extensions
(batch size, seed, explicit output paths, scripted gaze).
"""
