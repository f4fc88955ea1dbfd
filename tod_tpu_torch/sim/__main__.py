from tod_tpu_torch.sim.loop import main

if __name__ == "__main__":
    raise SystemExit(main())
