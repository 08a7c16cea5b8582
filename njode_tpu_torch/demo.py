"""Demo CLI of the port: train a new NJODE model on a synthetic dataset.

    python -m njode_tpu_torch.demo --dataset=BlackScholes --epochs=N [--device=cpu]

The counterpart of the repo's ``demo.py``: generates the dataset if missing
(20,000 paths) and trains the demo configuration (hidden 10, three 2x50
tanh MLPs, dropout 0.1, batch 100). The pretrained reference models
(``--model_id`` 1-3) and their plots are not ported yet (ROADMAP.md Queue 1
item 3)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Running NJODE (PyTorch/CUDA port)")
    parser.add_argument(
        "--dataset", type=str, default="BlackScholes",
        help="one of: 'BlackScholes', 'Heston', 'OrnsteinUhlenbeck'")
    parser.add_argument("--model_id", type=str, default="None",
                        help="None (pretrained ids are not ported yet)")
    parser.add_argument("--epochs", type=int, default=200,
                        help="int, number of epochs")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.model_id not in ("None", "none", ""):
        raise NotImplementedError(
            "pretrained model ids are not ported yet (ROADMAP.md Queue 1 "
            "item 3: the demo's pretrained ids and plots)")

    from njode_tpu_torch.data import datasets as data_utils
    from njode_tpu_torch.training import trainer

    if data_utils._get_time_id(args.dataset, None) is None:
        print(f"no dataset exists for: {args.dataset} -> generate dataset...")
        dataset_dict = dict(data_utils.hyperparam_default)
        dataset_dict["nb_paths"] = 20_000
        path, _ = data_utils.create_dataset(
            stock_model_name=args.dataset, hyperparam_dict=dataset_dict,
            device=args.device)
        print(f"dataset stored as: {path}")

    nn_desc = ((50, "tanh"), (50, "tanh"))
    trainer.train(
        model_id=None, epochs=args.epochs, batch_size=100, save_every=5,
        learning_rate=0.001, test_size=0.2, seed=398,
        hidden_size=10, bias=True, dropout_rate=0.1,
        ode_nn=nn_desc, enc_nn=nn_desc, readout_nn=nn_desc, use_rnn=False,
        which_loss="standard", residual_enc_dec=True,
        solver="euler", weight=0.5, weight_decay=1.0,
        dataset=args.dataset, dataset_id=None, plot=False,
        device=args.device)
    return 0


if __name__ == "__main__":
    main()
