from ccs_tpu_torch.cli import main

main()
