"""HDF5 end-to-end example (parity: reference examples/example_hdf5.py).

Two routes are shown:
  1. the native filter plugin (id 33030) through the standard h5py
     ``create_dataset(**EBCC_Filter(...))`` pipeline — identical usage to
     the reference filter;
  2. the plugin-free opaque-dataset helpers (works with stock h5py).

Run:  python examples/example_hdf5.py [output.h5]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_frame():
    path = "/root/reference/data/test_data.npy"
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    yy, xx = np.mgrid[0:721, 0:1440].astype(np.float32)
    return (260 + 25 * np.sin(yy / 721 * np.pi) * np.cos(xx / 1440 * 2 * np.pi)
            ).astype(np.float32)


def main():
    import ebcc_tpu.native as native

    # The plugin path must be in the environment BEFORE the HDF5 library
    # initializes (i.e. before importing h5py).
    native.load()  # builds on first use
    os.environ.setdefault("HDF5_PLUGIN_PATH", native.FILTER_DIR)

    import h5py

    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
    from ebcc_tpu.api import hdf5 as h5api
    from ebcc_tpu.api.filter_wrapper import EBCC_Filter

    out_path = sys.argv[1] if len(sys.argv) > 1 else "example_out.h5"
    data = load_frame()[None]  # (1, 721, 1440)
    max_error = 0.5
    filt = EBCC_Filter(base_cr=30, height=721, width=1440,
                       residual_opt=("max_error_target", max_error),
                       data_dim=3)
    with h5py.File(out_path, "w") as f:
        dset = f.create_dataset("via_plugin", shape=data.shape, **filt)
        dset[...] = data

    # Route 2: plugin-free opaque dataset (device codec, stock h5py).
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=max_error,
                         chunk_dims=(1, 721, 1440))
    with h5py.File(out_path, "a") as f:
        h5api.save_dataset(f, "via_codec", data, config)

    with h5py.File(out_path, "r") as f:
        out1 = f["via_plugin"][...]
        out2 = h5api.load_dataset(f, "via_codec")
    size = os.path.getsize(out_path)

    for name, out in [("plugin", out1), ("codec", out2)]:
        err = float(np.abs(out - data).max())
        print(f"{name}: max abs error = {err:.4f} (bound {max_error})")
        assert err <= max_error
    print(f"file: {size} bytes, combined CR ~ {2 * data.nbytes / size:.1f}")


if __name__ == "__main__":
    main()
