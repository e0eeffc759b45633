from dynamo_tpu_torch.launcher.launcher import main

main()
