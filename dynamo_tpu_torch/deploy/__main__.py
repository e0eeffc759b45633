from dynamo_tpu_torch.deploy import main

main()
